"""ctypes bindings of the port's native host runtime
(``csrc/host/arrow_tpu_native.cc``, the port's own copy of the JAX
package's C++ source).

Provides: ``MemoryPool`` (64-byte aligned host allocations with stats and
poisoning, the ``memory_pool.cc`` analog), ATB columnar files (zero-copy
mmap reads; the format of the spill runs and of the dataset's
engine-internal files, byte for byte the JAX package's, so that a file
either package writes reads in the other) and ``MorselLoader``
(background-thread file readahead, the ``dataset/scan_node.cc:86-123``
analog).

The shared library builds with ``g++ -O3 -std=c++17 -shared -fPIC
-pthread`` at first use into ``<repo>/.kernels_build/``, keyed by a hash
of the source, as the CUDA kernels are. A failed build raises with the
compiler's message wherever a caller needs the library; ``available()``
and ``build_error()`` report it without raising.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from pathlib import Path
from typing import Dict, Optional, Sequence, Tuple

import numpy as np

__all__ = ["available", "build_error", "MemoryPool", "write_atb",
           "read_atb", "open_atb", "AtbFile", "MorselLoader"]

_SRC = Path(__file__).resolve().parent / "csrc" / "host" / \
    "arrow_tpu_native.cc"
_BUILD_DIR = Path(__file__).resolve().parents[1] / ".kernels_build"
_FLAGS = ["-O3", "-std=c++17", "-shared", "-fPIC", "-pthread"]

_lib = None
_lib_lock = threading.Lock()
_build_error: Optional[str] = None

# dtype codes shared with the C++ side (opaque to it: it only moves bytes)
# and with the JAX package's native.py
_DTYPES = [np.dtype(x) for x in
           ["bool", "int8", "int16", "int32", "int64", "uint8", "uint16",
            "uint32", "uint64", "float16", "float32", "float64"]]
_DTYPE_CODE = {d: i for i, d in enumerate(_DTYPES)}
_VARLEN_CODE = 100  # byte pool


def library_path() -> Path:
    h = hashlib.sha256(" ".join(_FLAGS).encode())
    h.update(_SRC.read_bytes())
    return _BUILD_DIR / f"libarrow_tpu_native_{h.hexdigest()[:16]}.so"


def _build(so: Path) -> Optional[str]:
    """Compile the source into ``so`` (through a temporary file, so that
    processes building at once never load a half-written library);
    returns the compiler's message on failure."""
    so.parent.mkdir(parents=True, exist_ok=True)
    tmp = so.with_name(f"{so.name}.{os.getpid()}.tmp")
    cmd = ["g++", *_FLAGS, str(_SRC), "-o", str(tmp)]
    try:
        r = subprocess.run(cmd, capture_output=True, text=True, timeout=300)
    except (OSError, subprocess.TimeoutExpired) as e:  # no compiler
        return f"{' '.join(cmd)}: {type(e).__name__}: {e}"
    if r.returncode != 0:
        tmp.unlink(missing_ok=True)
        return f"{' '.join(cmd)} failed ({r.returncode}):\n" \
            f"{r.stderr[-4000:]}"
    os.replace(tmp, so)
    return None


def _declare(lib) -> None:
    c = ctypes
    vp, i64, i32 = c.c_void_p, c.c_int64, c.c_int
    sigs = {
        "atp_pool_create": (vp, [i32]),
        "atp_pool_destroy": (None, [vp]),
        "atp_pool_alloc": (vp, [vp, i64]),
        "atp_pool_free": (None, [vp, vp, i64]),
        "atp_pool_bytes_allocated": (i64, [vp]),
        "atp_pool_max_memory": (i64, [vp]),
        "atp_pool_num_allocations": (i64, [vp]),
        "atb_write": (i32, [c.c_char_p, i64, i32, c.POINTER(_AtbColDesc)]),
        "atb_open": (vp, [c.c_char_p]),
        "atb_close": (None, [vp]),
        "atb_nrows": (i64, [vp]),
        "atb_ncols": (i32, [vp]),
        "atb_col_name": (c.c_char_p, [vp, i32]),
        "atb_col_dtype": (i32, [vp, i32]),
        "atb_col_flags": (i32, [vp, i32]),
        "atb_col_data": (vp, [vp, i32, c.POINTER(i64)]),
        "atb_col_validity": (vp, [vp, i32]),
        "atb_col_offsets": (vp, [vp, i32]),
        "atp_loader_create": (vp, [c.POINTER(c.c_char_p), i32, i64, i32,
                                   i32]),
        "atp_loader_next": (i32, [vp, c.POINTER(vp), c.POINTER(i64),
                                  c.POINTER(i64), c.POINTER(i32)]),
        "atp_loader_failed": (i32, [vp]),
        "atp_loader_destroy": (None, [vp]),
    }
    for name, (res, args) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = res
        fn.argtypes = args


def _load():
    """The loaded library (built first if needed), or None with
    ``_build_error`` set."""
    global _lib, _build_error
    with _lib_lock:
        if _lib is not None or _build_error is not None:
            return _lib
        so = library_path()
        if not so.is_file():
            _build_error = _build(so)
            if _build_error is not None:
                return None
        lib = ctypes.CDLL(str(so))
        _declare(lib)
        _lib = lib
        return _lib


def _need():
    lib = _load()
    if lib is None:
        raise RuntimeError(f"the native host runtime did not build: "
                           f"{_build_error}")
    return lib


def available() -> bool:
    return _load() is not None


def build_error() -> Optional[str]:
    _load()
    return _build_error


class _Allocation(np.ndarray):
    """ndarray view over a pool allocation (carries the raw pointer)."""
    _atp_ptr = 0


class MemoryPool:
    """64-byte-aligned host allocator with stats (``memory_pool.cc``
    analog). ``poison`` fills alloc / free like ARROW_DEBUG_MEMORY_POOL.
    The JAX package's API; no module of this package allocates from it
    (spill runs stage through torch's pinned allocator)."""

    def __init__(self, poison: bool = False):
        lib = _need()
        self._lib = lib
        self._h = lib.atp_pool_create(1 if poison else 0)

    def alloc(self, nbytes: int) -> np.ndarray:
        ptr = self._lib.atp_pool_alloc(self._h, nbytes)
        if not ptr:
            raise MemoryError(nbytes)
        buf = (ctypes.c_uint8 * nbytes).from_address(ptr)
        arr = np.frombuffer(buf, dtype=np.uint8).view(_Allocation)
        arr._atp_ptr = ptr  # kept for free()
        return arr

    def free(self, arr: np.ndarray):
        self._lib.atp_pool_free(self._h, arr._atp_ptr, arr.nbytes)

    @property
    def bytes_allocated(self) -> int:
        return self._lib.atp_pool_bytes_allocated(self._h)

    @property
    def max_memory(self) -> int:
        return self._lib.atp_pool_max_memory(self._h)

    @property
    def num_allocations(self) -> int:
        return self._lib.atp_pool_num_allocations(self._h)

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.atp_pool_destroy(self._h)
            self._h = None


class _AtbColDesc(ctypes.Structure):
    _fields_ = [("name", ctypes.c_char_p),
                ("dtype_code", ctypes.c_uint8),
                ("has_validity", ctypes.c_uint8),
                ("is_varlen", ctypes.c_uint8),
                ("validity", ctypes.POINTER(ctypes.c_uint8)),
                ("offsets", ctypes.POINTER(ctypes.c_uint8)),
                ("data", ctypes.POINTER(ctypes.c_uint8)),
                ("data_bytes", ctypes.c_int64)]


def _u8ptr(arr: np.ndarray):
    return arr.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8))


def write_atb(path: str, columns: Dict[str, dict], nrows: int) -> int:
    """Write an ATB file; returns its size in bytes. ``columns`` maps
    name -> {"data": np.ndarray, "validity": bool (nrows,) or absent,
    "offsets": int32 (nrows + 1,) for a byte pool, or absent}. A fixed-
    width column's ``data`` holds ``nrows`` values of one of the codes'
    dtypes (more per row for a multi-lane storage: the reader gets them
    flat)."""
    lib = _need()
    descs = (_AtbColDesc * max(len(columns), 1))()
    keepalive = []
    for i, (name, col) in enumerate(columns.items()):
        data = np.ascontiguousarray(col["data"])
        validity = col.get("validity")
        offsets = col.get("offsets")
        is_varlen = offsets is not None
        if is_varlen and data.dtype != np.uint8:
            raise TypeError(f"column {name!r}: a byte pool is uint8, not "
                            f"{data.dtype}")
        if not is_varlen and data.dtype not in _DTYPE_CODE:
            raise TypeError(f"column {name!r}: ATB carries no {data.dtype}")
        if validity is not None and validity.shape[0] != nrows:
            raise ValueError(f"column {name!r}: {validity.shape[0]} "
                             f"validity bytes for {nrows} rows")
        if is_varlen and offsets.shape[0] != nrows + 1:
            raise ValueError(f"column {name!r}: {offsets.shape[0]} offsets "
                             f"for {nrows} rows")
        d = descs[i]
        nb = name.encode()
        keepalive.extend([data, nb])
        d.name = nb
        d.dtype_code = _VARLEN_CODE if is_varlen else _DTYPE_CODE[data.dtype]
        d.has_validity = 1 if validity is not None else 0
        d.is_varlen = 1 if is_varlen else 0
        if validity is not None:
            v = np.ascontiguousarray(validity, dtype=np.uint8) \
                if validity.dtype != np.bool_ else \
                np.ascontiguousarray(validity).view(np.uint8)
            keepalive.append(v)
            d.validity = _u8ptr(v)
        if is_varlen:
            o = np.ascontiguousarray(offsets, dtype=np.int32)
            keepalive.append(o)
            d.offsets = _u8ptr(o.view(np.uint8))
        d.data = _u8ptr(data.view(np.uint8).reshape(-1))
        d.data_bytes = data.nbytes
    rc = lib.atb_write(os.fsencode(path), nrows, len(columns), descs)
    if rc != 0:
        raise OSError(f"atb_write({path}) failed: {rc}")
    return os.path.getsize(path)


class AtbFile:
    """An open ATB file: ``nrows`` and ``columns`` (name -> {"data",
    "validity"?, "offsets"?}), every array a zero-copy view of the mmap,
    valid until ``close``. A context manager."""

    def __init__(self, path: str):
        lib = _need()
        h = lib.atb_open(os.fsencode(path))
        if not h:
            raise OSError(f"cannot open ATB file {path}")
        self._lib, self._h, self.path = lib, h, path
        self.nrows = lib.atb_nrows(h)
        self.columns = {}
        for c in range(lib.atb_ncols(h)):
            name, col = _column_views(lib, h, c, self.nrows)
            self.columns[name] = col

    def close(self):
        if self._h:
            self.columns = {}
            self._lib.atb_close(self._h)
            self._h = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass


def open_atb(path: str) -> AtbFile:
    return AtbFile(path)


def _view(ptr: int, nbytes: int) -> np.ndarray:
    if nbytes == 0:
        return np.zeros((0,), np.uint8)
    return np.ctypeslib.as_array(ctypes.cast(
        ptr, ctypes.POINTER(ctypes.c_uint8)), shape=(nbytes,))


def _column_views(lib, h, c: int, nrows: int):
    name = lib.atb_col_name(h, c).decode()
    code = lib.atb_col_dtype(h, c)
    flags = lib.atb_col_flags(h, c)
    nbytes = ctypes.c_int64()
    raw = _view(lib.atb_col_data(h, c, ctypes.byref(nbytes)), nbytes.value)
    col = {}
    if code == _VARLEN_CODE:
        col["data"] = raw
        col["offsets"] = _view(lib.atb_col_offsets(h, c),
                               (nrows + 1) * 4).view(np.int32)
    else:
        if not 0 <= code < len(_DTYPES):
            raise OSError(f"ATB column {name!r}: unknown dtype code {code}")
        col["data"] = raw.view(_DTYPES[code])
    if flags & 1:
        col["validity"] = _view(lib.atb_col_validity(h, c),
                                nrows).view(np.bool_)
    return name, col


def read_atb(path: str) -> Tuple[Dict[str, dict], int]:
    """Read an ATB file -> ({name: {data, validity?, offsets?}}, nrows),
    every array a copy."""
    with AtbFile(path) as f:
        return {name: {k: v.copy() for k, v in col.items()}
                for name, col in f.columns.items()}, f.nrows


class MorselLoader:
    """Background-thread morsel prefetcher over ATB files (the JAX
    package's API; ``acero/spill.read_run`` reads one run in order and
    does not use it).

    Iterating yields (file_index, {name: {data, validity?, offsets?}},
    nrows) morsels, sliced to ``morsel_rows`` by the C++ threads ahead of
    consumption (the readahead role of ``dataset/scan_node.cc``); a file
    the threads could not open raises at the end of the stream."""

    def __init__(self, paths: Sequence[str], morsel_rows: int = 1 << 15,
                 nthreads: int = 2, queue_depth: int = 8):
        lib = _need()
        self._lib = lib
        self._paths = list(paths)
        arr = (ctypes.c_char_p * max(len(paths), 1))(
            *[os.fsencode(p) for p in paths])
        self._h = lib.atp_loader_create(arr, len(paths), morsel_rows,
                                        nthreads, queue_depth)

    def __iter__(self):
        lib = self._lib
        fh = ctypes.c_void_p()
        rb = ctypes.c_int64()
        rc_ = ctypes.c_int64()
        fi = ctypes.c_int()
        while lib.atp_loader_next(self._h, ctypes.byref(fh),
                                  ctypes.byref(rb), ctypes.byref(rc_),
                                  ctypes.byref(fi)):
            nrows_total = lib.atb_nrows(fh)
            cols = {}
            lo, n = rb.value, rc_.value
            for c in range(lib.atb_ncols(fh)):
                name, col = _column_views(lib, fh, c, nrows_total)
                sliced = {}
                if "offsets" in col:
                    off = col["offsets"]
                    b0, b1 = int(off[lo]), int(off[lo + n])
                    sliced["data"] = col["data"][b0:b1].copy()
                    sliced["offsets"] = (off[lo:lo + n + 1] - off[lo]).copy()
                else:
                    sliced["data"] = col["data"][lo:lo + n].copy()
                if "validity" in col:
                    sliced["validity"] = col["validity"][lo:lo + n].copy()
                cols[name] = sliced
            yield fi.value, cols, n
        failed = lib.atp_loader_failed(self._h)
        if failed:
            raise OSError(f"MorselLoader: {failed} of {len(self._paths)} "
                          "ATB files could not be opened")

    def close(self):
        if self._h:
            self._lib.atp_loader_destroy(self._h)
            self._h = None

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
