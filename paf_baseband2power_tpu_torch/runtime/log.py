"""multilog-style logging.

The reference logs through PSRDADA ``multilog``: every process writes
``<dir>/<name>.log`` with LOG_INFO/LOG_ERR lines, and every error is
duplicated to stderr with file/line context (e.g. ``paf_capture.c:131-142``,
``capture.c:91``). This module reproduces that operational shape on top of
the stdlib, so each pipeline component gets the same per-process log file a
reference operator would look for.
"""

from __future__ import annotations

import logging
import os
import sys

_FMT = "[%(asctime)s] [%(levelname)s] %(message)s"


def open_log(name: str, directory: str | None = None,
             stderr_errors: bool = True) -> logging.Logger:
    """Create/fetch the per-process logger ``<directory>/<name>.log``."""
    logger = logging.getLogger(f"pafb2p.{name}")
    logger.setLevel(logging.DEBUG)
    logger.propagate = False
    if directory:
        os.makedirs(directory, exist_ok=True)
        path = os.path.abspath(os.path.join(directory, f"{name}.log"))
        have = any(
            isinstance(h, logging.FileHandler) and h.baseFilename == path
            for h in logger.handlers
        )
        if not have:
            fh = logging.FileHandler(path)
            fh.setFormatter(logging.Formatter(_FMT))
            fh.setLevel(logging.INFO)
            logger.addHandler(fh)
    if stderr_errors and not any(
        isinstance(h, logging.StreamHandler)
        and not isinstance(h, logging.FileHandler)
        for h in logger.handlers
    ):
        eh = logging.StreamHandler(sys.stderr)
        eh.setFormatter(logging.Formatter(_FMT))
        eh.setLevel(logging.ERROR)
        logger.addHandler(eh)
    if not logger.handlers:
        logger.addHandler(logging.NullHandler())
    return logger
