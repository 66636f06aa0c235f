"""Python binding for the native shared-memory ring buffer.

ctypes wrapper over ``native/ringbuf.cpp``. ``g++`` builds it at first use,
with the capture engine (``native/capture.cpp``, which calls the ring code
itself) and the sender (``native/sender.cpp``), into one library in the
git-ignored ``.build/`` (``ops/_build.py:build_host_library``, the library
named after a hash of its sources), as the JAX package's
``native/Makefile`` builds ``libpafb2p.so``: one process never holds two
copies of the ring code. Blocks are exposed as zero-copy numpy views of the
mapped shm, so the compute stage reads exactly the bytes a writer process
produced (``capture.c:586-642``, ``diskdb.cu:24-67``).

A copy of the JAX package's ``io/ringbuffer.py`` and of its ``native/``
sources. The shared memory layout and the segment names
(``/dev/shm/pafb2p-<key>``) are the same byte for byte, so each package's
stages read the rings the other's write.

Layered API:
  * :class:`RingBuffer` — raw protocol (create/connect, open/close block,
    header channel, SOD/EOD).
  * :class:`RingSource` / :class:`RingSink` — pipeline adapters speaking
    canonical int16 blocks / float32 power records.
"""

from __future__ import annotations

import ctypes
import os
import threading
from typing import Iterator

import numpy as np

from .. import constants as C
from ..ops import _build
from .dada import DadaHeader

NATIVE_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "native")
NATIVE_SOURCES = ("ringbuf", "capture", "sender")
_build_lock = threading.Lock()
_lib = None


def build_native(variant: str = "", build_dir: str | None = None) -> str:
    """Build the host library, or its ``debug``, ``tsan`` or ``asan``
    variant (``ops/_build.py:HOST_VARIANTS``), unless it is built; returns
    its path."""
    return _build.build_host_library(
        f"libpafb2p.{variant}" if variant else "libpafb2p",
        [os.path.join(NATIVE_DIR, f"{n}.cpp") for n in NATIVE_SOURCES],
        [os.path.join(NATIVE_DIR, f"{n}.h") for n in NATIVE_SOURCES],
        build_dir=build_dir, flags=_build.HOST_VARIANTS[variant])


def load_library() -> ctypes.CDLL:
    """Load the native library, building it first if needed.
    ``PAFB2P_NATIVE_LIB`` names another build to load instead (a variant
    from ``cli/rebuild.py``, as in the JAX package); a sanitizer's runtime
    must then be in ``LD_PRELOAD``."""
    global _lib
    with _build_lock:
        if _lib is not None:
            return _lib
        lib = ctypes.CDLL(os.environ.get("PAFB2P_NATIVE_LIB")
                          or build_native())
        u64, u32, i32 = ctypes.c_uint64, ctypes.c_uint32, ctypes.c_int
        p_u8 = ctypes.POINTER(ctypes.c_uint8)
        sigs = {
            "pafb2p_rb_create_ex": (i32, [ctypes.c_char_p, u64, u32, u32,
                                          u32, u32]),
            "pafb2p_rb_pages_locked": (i32, [ctypes.c_void_p]),
            "pafb2p_rb_destroy": (i32, [ctypes.c_char_p]),
            "pafb2p_rb_connect": (ctypes.c_void_p, [ctypes.c_char_p]),
            "pafb2p_rb_disconnect": (None, [ctypes.c_void_p]),
            "pafb2p_rb_bufsz": (u64, [ctypes.c_void_p]),
            "pafb2p_rb_nbufs": (u32, [ctypes.c_void_p]),
            "pafb2p_rb_hdrsz": (u32, [ctypes.c_void_p]),
            "pafb2p_rb_nreaders": (u32, [ctypes.c_void_p]),
            "pafb2p_rb_write_header": (i32, [ctypes.c_void_p, ctypes.c_char_p,
                                             ctypes.c_size_t]),
            "pafb2p_rb_read_header": (i32, [ctypes.c_void_p, ctypes.c_char_p,
                                            ctypes.c_size_t, u64]),
            "pafb2p_rb_lock_write": (i32, [ctypes.c_void_p]),
            "pafb2p_rb_unlock_write": (i32, [ctypes.c_void_p]),
            "pafb2p_rb_open_block_write": (p_u8, [ctypes.c_void_p, u64]),
            "pafb2p_rb_close_block_write": (i32, [ctypes.c_void_p, u64]),
            "pafb2p_rb_set_eod": (i32, [ctypes.c_void_p]),
            "pafb2p_rb_set_sod": (i32, [ctypes.c_void_p]),
            "pafb2p_rb_sod_block": (ctypes.c_int64, [ctypes.c_void_p]),
            "pafb2p_rb_wait_sod": (ctypes.c_int64, [ctypes.c_void_p, u64]),
            "pafb2p_rb_lock_read": (i32, [ctypes.c_void_p]),
            "pafb2p_rb_unlock_read": (i32, [ctypes.c_void_p]),
            "pafb2p_rb_open_block_read": (p_u8, [ctypes.c_void_p,
                                                 ctypes.POINTER(u64), u64]),
            "pafb2p_rb_close_block_read": (i32, [ctypes.c_void_p]),
            "pafb2p_rb_at_eod": (i32, [ctypes.c_void_p]),
            "pafb2p_rb_blocks_written": (u64, [ctypes.c_void_p]),
            "pafb2p_rb_blocks_read": (u64, [ctypes.c_void_p]),
            "pafb2p_rb_blocks_full": (u64, [ctypes.c_void_p]),
        }
        for name, (restype, argtypes) in sigs.items():
            fn = getattr(lib, name)
            fn.restype = restype
            fn.argtypes = argtypes
        _lib = lib
        return _lib


class RingBufferError(OSError):
    pass


def _check(rc: int, what: str) -> None:
    if rc < 0:
        raise RingBufferError(-rc, f"{what}: {os.strerror(-rc)}")


#: create() flag: mlock the segment in every connecting process
LOCK_PAGES = 0x1


def create(key: str, bufsz: int, nbufs: int,
           hdrsz: int = C.DADA_HDR_SIZE, nreader: int = 1,
           lock_pages: bool = False) -> None:
    """Create a ring (the ``dada_db -l -r NREADER`` analogue,
    paf-baseband2power.py:114). Every block must be released by all
    ``nreader`` reader clients before the writer may reuse it.

    ``lock_pages``: mlock the segment in every connecting process (the
    ``-l`` in ``dada_db -l``): a multi-GB ring paging mid-stream is data
    loss. Best effort — RLIMIT_MEMLOCK denial degrades to unlocked
    (check ``RingBuffer.pages_locked``)."""
    _check(load_library().pafb2p_rb_create_ex(
        key.encode(), bufsz, nbufs, hdrsz, nreader,
        LOCK_PAGES if lock_pages else 0),
        f"create ring '{key}'")


def destroy(key: str) -> None:
    """Destroy a ring (the ``dada_db -d`` analogue)."""
    _check(load_library().pafb2p_rb_destroy(key.encode()),
           f"destroy ring '{key}'")


def exists(key: str) -> bool:
    return os.path.exists(f"/dev/shm/pafb2p-{key}")


class RingBuffer:
    """A connected ring-buffer client (writer or reader role via lock_*)."""

    DEFAULT_TIMEOUT_US = 60_000_000

    def __init__(self, key: str):
        self._lib = load_library()
        self.key = key
        self._h = self._lib.pafb2p_rb_connect(key.encode())
        if not self._h:
            raise RingBufferError(
                2, f"connect ring '{key}': not found or invalid segment")

    # geometry --------------------------------------------------------------
    @property
    def bufsz(self) -> int:
        return self._lib.pafb2p_rb_bufsz(self._h)

    @property
    def nbufs(self) -> int:
        return self._lib.pafb2p_rb_nbufs(self._h)

    @property
    def hdrsz(self) -> int:
        return self._lib.pafb2p_rb_hdrsz(self._h)

    @property
    def nreaders(self) -> int:
        return self._lib.pafb2p_rb_nreaders(self._h)

    @property
    def pages_locked(self) -> bool:
        """True if this process's mapping of the segment is mlocked."""
        return bool(self._lib.pafb2p_rb_pages_locked(self._h))

    # header channel --------------------------------------------------------
    def write_header(self, header: DadaHeader | bytes) -> None:
        raw = header.serialize(self.hdrsz) if isinstance(header, DadaHeader) \
            else header
        _check(self._lib.pafb2p_rb_write_header(self._h, raw, len(raw)),
               "write header")

    def read_header(self, timeout_us: int | None = None) -> DadaHeader:
        buf = ctypes.create_string_buffer(self.hdrsz)
        rc = self._lib.pafb2p_rb_read_header(
            self._h, buf, self.hdrsz,
            self.DEFAULT_TIMEOUT_US if timeout_us is None else timeout_us)
        _check(rc, "read header")
        return DadaHeader.parse(buf.raw)

    # writer ----------------------------------------------------------------
    def lock_write(self) -> None:
        _check(self._lib.pafb2p_rb_lock_write(self._h), "lock write")

    def unlock_write(self) -> None:
        _check(self._lib.pafb2p_rb_unlock_write(self._h), "unlock write")

    def open_block_write(self, timeout_us: int | None = None) -> np.ndarray:
        ptr = self._lib.pafb2p_rb_open_block_write(
            self._h,
            self.DEFAULT_TIMEOUT_US if timeout_us is None else timeout_us)
        if not ptr:
            raise TimeoutError(f"ring '{self.key}': open_block_write timed out")
        return np.ctypeslib.as_array(ptr, shape=(self.bufsz,))

    def close_block_write(self, nbytes: int | None = None) -> None:
        _check(self._lib.pafb2p_rb_close_block_write(
            self._h, self.bufsz if nbytes is None else nbytes),
            "close block write")

    def set_eod(self) -> None:
        _check(self._lib.pafb2p_rb_set_eod(self._h), "set eod")

    def set_sod(self) -> None:
        """Mark start-of-data at the current write cursor: the next block
        committed is the observation's first (``ipcbuf_enable_sod``
        analogue, ``capture.c:622-639``). Call before committing it."""
        _check(self._lib.pafb2p_rb_set_sod(self._h), "set sod")

    @property
    def sod_block(self) -> int:
        """SOD block index, or -1 while unset."""
        return self._lib.pafb2p_rb_sod_block(self._h)

    # reader ----------------------------------------------------------------
    def lock_read(self) -> None:
        _check(self._lib.pafb2p_rb_lock_read(self._h), "lock read")

    def unlock_read(self) -> None:
        _check(self._lib.pafb2p_rb_unlock_read(self._h), "unlock read")

    def open_block_read(self, timeout_us: int | None = None
                        ) -> np.ndarray | None:
        """Next committed block as a zero-copy view, or None at EOD."""
        nbytes = ctypes.c_uint64(0)
        ptr = self._lib.pafb2p_rb_open_block_read(
            self._h, ctypes.byref(nbytes),
            self.DEFAULT_TIMEOUT_US if timeout_us is None else timeout_us)
        if not ptr:
            if self.at_eod():
                return None
            raise TimeoutError(f"ring '{self.key}': open_block_read timed out")
        return np.ctypeslib.as_array(ptr, shape=(nbytes.value,))

    def close_block_read(self) -> None:
        _check(self._lib.pafb2p_rb_close_block_read(self._h),
               "close block read")

    def at_eod(self) -> bool:
        return bool(self._lib.pafb2p_rb_at_eod(self._h))

    def wait_sod(self, timeout_us: int | None = None) -> int:
        """Wait for the observation start and fast-forward to it.

        Committed pre-SOD blocks are discarded (released back to the
        writer as they arrive, so waiting never stalls the stream);
        returns the SOD block index once this reader stands on it."""
        rc = self._lib.pafb2p_rb_wait_sod(
            self._h,
            self.DEFAULT_TIMEOUT_US if timeout_us is None else timeout_us)
        if rc < 0:
            _check(int(rc), "wait sod")
        return int(rc)

    # observability ---------------------------------------------------------
    @property
    def blocks_written(self) -> int:
        return self._lib.pafb2p_rb_blocks_written(self._h)

    @property
    def blocks_read(self) -> int:
        return self._lib.pafb2p_rb_blocks_read(self._h)

    @property
    def blocks_full(self) -> int:
        return self._lib.pafb2p_rb_blocks_full(self._h)

    def disconnect(self) -> None:
        if self._h:
            self._lib.pafb2p_rb_disconnect(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.disconnect()


class RingSource:
    """Pipeline source: read baseband blocks from a ring (reader client).

    ``layout``: ``"wire"`` (TFTFP, blocks viewed ``(ndf, lanes)``) or
    ``"rows"`` (the capture engine's ``device_layout`` corner-turned form,
    viewed ``(nseries, ndf*256)``). Bytes are identical in count; only
    the view differs.
    """

    def __init__(self, key: str, ndf: int = C.NDF_BLK, nchk: int = C.NCHK_NIC,
                 timeout_us: int | None = None, layout: str = "wire",
                 wait_sod: bool = False):
        if layout not in ("wire", "rows"):
            raise ValueError(f"unknown layout '{layout}'")
        self._rb = RingBuffer(key)
        self._rb.lock_read()
        self._ndf, self._nchk = ndf, nchk
        self._layout = layout
        self._timeout = timeout_us
        expect = ndf * nchk * C.DT_SIZE
        bufsz = self._rb.bufsz
        if bufsz != expect:
            # size check at attach, like capture.c:600-612 / diskdb.cu:34-42
            self._rb.unlock_read()
            self._rb.disconnect()
            raise RingBufferError(
                22, f"ring '{key}' bufsz {bufsz} != expected {expect}")
        #: first observation block this source will yield (0 unless
        #: wait_sod skipped pre-observation blocks)
        self.start_block = 0
        if wait_sod:
            try:
                self.start_block = self._rb.wait_sod(timeout_us)
            except Exception:
                self._rb.unlock_read()
                self._rb.disconnect()
                raise
        self.header = self._rb.read_header(timeout_us)

    def set_layout(self, layout: str) -> None:
        """Switch the block view (callers discover ORDER from the header
        this source has already read)."""
        if layout not in ("wire", "rows"):
            raise ValueError(f"unknown layout '{layout}'")
        self._layout = layout

    def __iter__(self) -> Iterator[np.ndarray]:
        while True:
            view = self._rb.open_block_read(self._timeout)
            if view is None:
                break
            # copy out: the block is recycled after close; 2-D device layout
            if self._layout == "rows":
                nseries = self._nchk * C.NCHAN_CHK * C.NPOL_SAMP
                block = view.view("<i2").reshape(nseries, -1).copy()
            else:
                block = view.view("<i2").reshape(self._ndf, -1).copy()
            self._rb.close_block_read()
            yield block
        self._rb.unlock_read()
        self._rb.disconnect()


class RingSink:
    """Pipeline sink: write power records into a ring (writer client)."""

    def __init__(self, key: str, header: DadaHeader | None = None,
                 timeout_us: int | None = None):
        self._rb = RingBuffer(key)
        self._rb.lock_write()
        self._timeout = timeout_us
        if header is not None:
            self._rb.write_header(header)

    def write(self, power: np.ndarray) -> None:
        raw = np.ascontiguousarray(power, dtype="<f4").tobytes()
        view = self._rb.open_block_write(self._timeout)
        if len(raw) > view.nbytes:
            raise RingBufferError(90, f"record {len(raw)} B > block {view.nbytes} B")
        view[: len(raw)] = np.frombuffer(raw, np.uint8)
        self._rb.close_block_write(len(raw))

    def close(self) -> None:
        self._rb.set_eod()
        self._rb.unlock_write()
        self._rb.disconnect()
