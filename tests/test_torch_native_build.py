"""Build the JAX package's native library once, under a lock, before any
test loads it, and repair a torn build.

The JAX package's ``io/ringbuffer.py:load_library`` runs ``make -C
native`` on its first load in every process, guarded only by a thread
lock. Under ``pytest -n N`` several workers reach it at once on a tree
whose objects and library are git-ignored and absent. While one ``make``
compiles ``sender.o``, the assembler has already truncated the file to 0
bytes with a fresh mtime; a second ``make`` that looks at that moment
takes the empty object as up to date and links it, and GNU ld accepts an
empty object without a word. The library then lacks every ``pafb2p_sender_*``
symbol, the capture engine crashes on first use, and since the torn
library is newer than every object, each later ``make`` says "Nothing to
be done": it stays torn.

The module body below runs in every xdist worker during collection, and
xdist hands out no test before every worker has collected, so by the time
any test runs the library is built and whole, and every later ``make`` from
``load_library`` is a no-op that writes nothing. The build holds an
``fcntl.flock`` on a lock file outside the checkout, checks in a
subprocess (a process that dlopens a torn file keeps that handle for the
path) that the library exports every symbol the JAX bindings declare, and
if one is missing rebuilds from clean once under the same lock. It touches
only the git-ignored build outputs of ``native/``.
"""

from __future__ import annotations

import contextlib
import fcntl
import glob
import hashlib
import json
import os
import re
import shutil
import subprocess
import sys
import tempfile

import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NATIVE = os.path.join(REPO, "paf_baseband2power_tpu", "native")
LIB = "libpafb2p.so"
# the ctypes bindings whose symbols the library must export
BINDINGS = [os.path.join(REPO, "paf_baseband2power_tpu", "io", name)
            for name in ("ringbuffer.py", "capture.py", "sender.py")]


def declared_symbols() -> list[str]:
    """Every ``pafb2p_*`` name the JAX package's bindings look up."""
    names: set[str] = set()
    for path in BINDINGS:
        with open(path) as f:
            names.update(re.findall(r"\bpafb2p_\w+", f.read()))
    return sorted(names)


def missing_symbols(lib_path: str, names: list[str]) -> list[str]:
    """The names ``lib_path`` does not export, looked up in a process of
    its own so this one never maps the file."""
    code = ("import ctypes, json, sys\n"
            "lib = ctypes.CDLL(sys.argv[1])\n"
            "print(json.dumps([n for n in sys.argv[2:] "
            "if not hasattr(lib, n)]))\n")
    r = subprocess.run([sys.executable, "-c", code, lib_path, *names],
                       capture_output=True, text=True, timeout=60)
    if r.returncode:
        raise RuntimeError(f"loading {lib_path} failed: {r.stderr[-2000:]}")
    return json.loads(r.stdout)


@contextlib.contextmanager
def build_lock(native_dir: str):
    """An exclusive ``flock`` on a lock file named by ``native_dir``'s
    path, in the temp directory, so every process that builds the same
    tree waits for the others."""
    tag = hashlib.sha1(os.path.realpath(native_dir).encode()).hexdigest()[:16]
    path = os.path.join(tempfile.gettempdir(), f"pafb2p-native-{tag}.lock")
    with open(path, "a") as f:
        fcntl.flock(f, fcntl.LOCK_EX)
        try:
            yield
        finally:
            fcntl.flock(f, fcntl.LOCK_UN)


def _make(native_dir: str, *targets: str) -> None:
    subprocess.run(["make", "-C", native_dir, *targets], check=True,
                   capture_output=True, timeout=600)


def ensure_whole_library(native_dir: str = NATIVE) -> list[str]:
    """Build ``native_dir``'s library under the lock and check it; rebuild
    from clean once if a declared symbol is missing. Returns the steps
    taken; raises if the library is still not whole."""
    names = declared_symbols()
    lib_path = os.path.join(native_dir, LIB)
    with build_lock(native_dir):
        _make(native_dir)
        if not missing_symbols(lib_path, names):
            return ["make"]
        _make(native_dir, "clean")
        _make(native_dir)
        missing = missing_symbols(lib_path, names)
        if missing:
            raise RuntimeError(f"{lib_path} lacks {missing} after a clean "
                               "rebuild")
        return ["make", "make clean", "make"]


# collection-time build: runs in every worker before any test runs
ensure_whole_library()


def test_bindings_declare_the_sender_and_capture_symbols():
    names = declared_symbols()
    for name in ("pafb2p_rb_create", "pafb2p_capture_create",
                 "pafb2p_sender_run"):
        assert name in names


def test_in_tree_library_is_whole():
    lib_path = os.path.join(NATIVE, LIB)
    assert os.path.exists(lib_path)
    assert missing_symbols(lib_path, declared_symbols()) == []
    # a whole tree makes nothing: later loads write no file
    r = subprocess.run(["make", "-q", "-C", NATIVE], capture_output=True)
    assert r.returncode == 0


def _copy_native(dst: str) -> str:
    os.makedirs(dst)
    for path in glob.glob(os.path.join(NATIVE, "*")):
        if path.endswith((".cpp", ".h")) or os.path.basename(path) == \
                "Makefile":
            shutil.copy2(path, dst)
    return dst


def _plant_torn_library(native_dir: str) -> None:
    """What the race leaves behind: the library linked with an empty
    ``sender.o`` (as ld silently does), newer than every object."""
    empty = os.path.join(native_dir, "empty.o")
    open(empty, "w").close()
    subprocess.run(["g++", "ringbuf.o", "capture.o", "empty.o", "-shared",
                    "-pthread", "-lrt", "-o", LIB], cwd=native_dir,
                   check=True, capture_output=True)
    os.remove(empty)
    newest = max(os.stat(p).st_mtime
                 for p in glob.glob(os.path.join(native_dir, "*.o")))
    os.utime(os.path.join(native_dir, LIB), (newest + 10, newest + 10))


@pytest.mark.parametrize("torn", [True, False], ids=["torn", "whole"])
def test_repair_turns_a_torn_library_whole(tmp_path, torn):
    native_dir = _copy_native(str(tmp_path / "native"))
    _make(native_dir)
    lib_path = os.path.join(native_dir, LIB)
    names = declared_symbols()
    if torn:
        _plant_torn_library(native_dir)
        assert "pafb2p_sender_run" in missing_symbols(lib_path, names)
        # plain make does not see it: the torn library is the newest file
        _make(native_dir)
        assert "pafb2p_sender_run" in missing_symbols(lib_path, names)
    steps = ensure_whole_library(native_dir)
    assert steps == (["make", "make clean", "make"] if torn else ["make"])
    assert missing_symbols(lib_path, names) == []
