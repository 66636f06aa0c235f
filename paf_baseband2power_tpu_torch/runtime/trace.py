"""The program's own spans, for whatever torch profiler is recording: the
benchmark's traced run, the CLI's ``--profile DIR`` or a caller's own.

``span(name)`` is a ``torch.profiler.record_function`` named
``pafb2p.<name>`` while a profiler records, and one shared null context
otherwise: then a span costs a module-global read. The flag is the
profiler module's global, read through the module on every call, because
``torch.autograd._profiler_enabled()`` reads False on a thread other than
the one that started the profiler, and under ``profile_all_threads`` on
that one too.
"""

from __future__ import annotations

import contextlib

import torch
import torch.autograd.profiler as _profiler

PREFIX = "pafb2p."
_OFF = contextlib.nullcontext()


def span(name: str):
    """A ``with`` context that records ``pafb2p.<name>`` while a torch
    profiler records, and does nothing otherwise."""
    if _profiler._is_profiler_enabled:
        return torch.profiler.record_function(PREFIX + name)
    return _OFF
