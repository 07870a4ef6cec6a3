"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

The counterpart of the JAX package's ``ops/pallas_kernels.py`` for the
kernels on the filter -> group-by paths:

  * ``filter_compact_chunks`` (csrc/filter_compact.cu): stream compaction
    of (cap, C) u8 byte planes;
  * ``tile_compact_local`` (csrc/tile_compact.cu): per 1024-row tile, the
    local indices of the selected rows packed to the front, and their count
    (level 1 of the take-index filter);
  * ``dense_group_reduce`` (csrc/dense_group.cu): per-slot reductions over a
    dense group id.

Each wrapper takes the plain PyTorch version (``*_plain``, same module) only
when its tensors lie on the CPU. CUDA tensors launch the kernel or raise;
nothing falls back. ``LAUNCHES`` counts kernel launches per wrapper, so a
run can show that its path went through the kernels.

The sources build at first use with nvcc into ``<repo>/.kernels_build/``
(one compile per source, all started together, linked into one shared
library with a plain C interface and loaded with ctypes), keyed by a hash
of the sources and flags.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from pathlib import Path
from typing import List, Sequence, Tuple

import torch

__all__ = ["filter_compact_chunks", "filter_compact_chunks_plain",
           "tile_compact_local", "tile_compact_local_plain",
           "dense_group_reduce", "dense_group_reduce_plain", "build",
           "LAUNCHES", "reset_launch_counts", "TILE_ROWS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / ".kernels_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches per wrapper (only where the wrapper launches its kernel)
LAUNCHES = {"filter_compact_chunks": 0, "tile_compact_local": 0,
            "dense_group_reduce": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- build and load ---------------------------------------------------------

def _find_nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    for root in (os.environ.get("CUDA_HOME"), "/usr/local/cuda"):
        if root and (Path(root) / "bin" / "nvcc").is_file():
            return str(Path(root) / "bin" / "nvcc")
    raise RuntimeError("nvcc not found (PATH, $CUDA_HOME/bin, "
                       "/usr/local/cuda/bin): the CUDA kernels cannot build")


def build() -> Tuple[Path, str]:
    """Compile csrc/*.cu into one shared library if it is not built yet:
    one nvcc per source, all started together, then one link. Returns
    (library path, compiler output — empty when already built)."""
    sources = sorted(_CSRC.glob("*.cu"))
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for s in sources + sorted(_CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    lib = _BUILD_DIR / f"libarrow_tpu_torch_{tag}.so"
    if lib.is_file():
        return lib, ""
    _BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = _find_nvcc()
    stem = f"{tag}.{os.getpid()}"
    objs = [_BUILD_DIR / f"{s.stem}.{stem}.o" for s in sources]
    procs = [subprocess.Popen(
        [nvcc, *_NVCC_FLAGS, "-c", "-o", str(o), str(s)],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for s, o in zip(sources, objs)]
    log, failed = "", []
    for s, proc in zip(sources, procs):
        out, _ = proc.communicate()
        log += out
        if proc.returncode != 0:
            failed.append(f"{s.name} ({proc.returncode})")
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    tmp = _BUILD_DIR / f"lib.{stem}.tmp"
    link = subprocess.run([nvcc, "-shared", "-o", str(tmp), *map(str, objs)],
                          capture_output=True, text=True)
    log += link.stdout + link.stderr
    if link.returncode != 0:
        raise RuntimeError(f"nvcc link failed ({link.returncode}):\n{log}")
    os.replace(tmp, lib)
    for o in objs:
        o.unlink()
    return lib, log


_lib_handle = None


def _lib():
    global _lib_handle
    if _lib_handle is None:
        path, _ = build()
        lib = ctypes.CDLL(str(path))
        vp, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
        p_i32 = ctypes.POINTER(ctypes.c_int)
        p_i64 = ctypes.POINTER(ctypes.c_int64)
        sigs = {
            "atp_fc_tile_rows": [],
            "atp_fc_count": [vp, i64, vp, vp],
            "atp_fc_scatter": [vp, vp, vp, i64, i32, vp, vp],
            "atp_tc_tile_rows": [],
            "atp_tile_compact_local": [vp, i64, vp, vp, vp],
            "atp_dense_group_reduce": [vp, i64, i32, i32, p_i32, p_i64,
                                       p_i64, p_i64, p_i64, vp, vp, i64,
                                       vp],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        _lib_handle = lib
    return _lib_handle


def _check_rc(rc: int, what: str) -> None:
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA error {rc}")


def _on_cpu(tensors) -> bool:
    """True if every tensor lies on the CPU; False if all lie on one CUDA
    device; raises otherwise (the wrappers never copy between devices)."""
    devs = {t.device for t in tensors}
    if len(devs) != 1:
        raise ValueError(
            f"tensors on several devices: {sorted(map(str, devs))}")
    dev = devs.pop()
    if dev.type == "cpu":
        return True
    if dev.type != "cuda":
        raise ValueError(f"no kernel for device {dev}")
    return False


def _require(cond: bool, msg: str) -> None:
    if not cond:
        raise ValueError(msg)


# ---- filter_compact_chunks ---------------------------------------------------

def filter_compact_chunks_plain(sel: torch.Tensor,
                                chunks: torch.Tensor) -> torch.Tensor:
    """Plain version: one scatter of the selected rows to their ranks (the
    dump row ``cap`` takes the rest). Rows past the count are zero."""
    cap, C = chunks.shape
    dst = torch.where(sel, torch.cumsum(sel, 0) - 1, cap)
    out = chunks.new_zeros((cap + 1, C))
    out.index_copy_(0, dst, chunks)
    return out[:cap]


def filter_compact_chunks(sel: torch.Tensor,
                          chunks: torch.Tensor) -> torch.Tensor:
    """(cap,) bool selection + (cap, C) u8 byte planes -> (cap, C) u8 with
    the selected rows packed to the front in order; rows past the count
    are unspecified (callers track the count). Any cap works.

    C is the byte width of all fixed-width columns side by side, so one
    pass compacts every column at once."""
    _require(chunks.ndim == 2 and chunks.dtype == torch.uint8,
             "chunks must be (cap, C) uint8")
    _require(sel.shape == chunks.shape[:1] and sel.dtype == torch.bool,
             "sel must be (cap,) bool")
    if _on_cpu((sel, chunks)):
        return filter_compact_chunks_plain(sel, chunks)
    _require(sel.is_contiguous() and chunks.is_contiguous(),
             "filter_compact_chunks needs contiguous tensors")
    lib = _lib()
    cap, C = chunks.shape
    dev = chunks.device
    tile = lib.atp_fc_tile_rows()
    counts = torch.empty((-(-cap // tile),), dtype=torch.int32, device=dev)
    out = torch.empty_like(chunks)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check_rc(lib.atp_fc_count(sel.data_ptr(), cap, counts.data_ptr(),
                                   stream), "filter_compact_chunks count")
        starts = torch.cumsum(counts, 0, dtype=torch.int64) - counts
        _check_rc(lib.atp_fc_scatter(sel.data_ptr(), chunks.data_ptr(),
                                     out.data_ptr(), cap, C,
                                     starts.data_ptr(), stream),
                  "filter_compact_chunks scatter")
    LAUNCHES["filter_compact_chunks"] += 1
    return out


# ---- tile_compact_local ------------------------------------------------------

TILE_ROWS = 1024        # csrc/tile_compact.cu kTile; the TPU kernel's tile


def _check_tc(sel: torch.Tensor) -> None:
    _require(sel.ndim == 1 and sel.dtype == torch.bool,
             "sel must be (cap,) bool")
    _require(sel.shape[0] % TILE_ROWS == 0,
             f"cap must be a multiple of {TILE_ROWS}: {sel.shape[0]}")


def tile_compact_local_plain(sel: torch.Tensor):
    """Plain version on (T, 1024) views: a cumsum along each tile ranks its
    selected rows, and one scatter along the tile writes each selected
    row's local index at its rank (column 1024 takes the rest)."""
    _check_tc(sel)
    T = sel.shape[0] // TILE_ROWS
    s2 = sel.view(T, TILE_ROWS)
    incl = torch.cumsum(s2, 1)
    dst = torch.where(s2, incl - 1, TILE_ROWS)
    iota = torch.arange(TILE_ROWS, dtype=torch.int32, device=sel.device)
    loc = torch.zeros((T, TILE_ROWS + 1), dtype=torch.int32,
                      device=sel.device)
    loc.scatter_(1, dst, iota.expand(T, TILE_ROWS))
    counts = incl[:, -1].to(torch.int32) if T else \
        torch.zeros((0,), dtype=torch.int32, device=sel.device)
    return loc[:, :TILE_ROWS].reshape(-1), counts


def tile_compact_local(sel: torch.Tensor):
    """(cap,) bool, cap % 1024 == 0 -> (loc (cap,) int32, counts
    (cap / 1024,) int32): per 1024-row tile, the tile-local indices of its
    selected rows packed to the tile's front in row order (slots past the
    tile's count hold 0), and the tile's selected count. Level 2
    (``ops/selection.py``) stitches the tiles into take indices."""
    _check_tc(sel)
    if _on_cpu((sel,)):
        return tile_compact_local_plain(sel)
    _require(sel.is_contiguous(), "tile_compact_local needs a contiguous "
             "tensor")
    lib = _lib()
    _require(lib.atp_tc_tile_rows() == TILE_ROWS,
             "csrc/tile_compact.cu and TILE_ROWS disagree")
    cap = sel.shape[0]
    dev = sel.device
    loc = torch.empty((cap,), dtype=torch.int32, device=dev)
    counts = torch.empty((cap // TILE_ROWS,), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        _check_rc(lib.atp_tile_compact_local(
            sel.data_ptr(), cap, loc.data_ptr(), counts.data_ptr(), stream),
            "tile_compact_local")
    LAUNCHES["tile_compact_local"] += 1
    return loc, counts


# ---- dense_group_reduce ------------------------------------------------------

# The TPU kernel's constants (pallas_kernels.py _DG_IDENT / _DG_ARITY):
# kind -> (#inputs, #outputs) and the identity an empty slot keeps.
_DG_IDENT = {
    "sum": 0.0, "min": float("inf"), "max": float("-inf"),
    "imin": (1 << 31) - 1, "imax": -(1 << 31), "count": 0, "sumc": 0,
}
_DG_ARITY = {
    "sum": (1, 1), "min": (1, 1), "max": (1, 1), "imin": (1, 1),
    "imax": (1, 1), "count": (1, 1), "sumc": (1, 2),
    "imin64": (2, 2), "imax64": (2, 2),
}
# kind codes of csrc/dense_group.cu
_DG_KINDS = {"sum": 0, "min": 1, "max": 2, "imin": 3, "imax": 4,
             "count": 5, "sumc": 6, "imin64": 7, "imax64": 8}
_DG_F32 = ("sum", "min", "max")
_I64MAX = (1 << 63) - 1
_I64MIN = -(1 << 63)
_BIAS32 = 0x80000000
_U32 = 0xFFFFFFFF
# Shared memory one launch may use: half of the 227 KB a block can have,
# so that two blocks fit on an SM. Kinds past it go to another launch.
_DG_SMEM_BUDGET = 227 * 1024 // 2
_DG_MAX_KINDS = 16          # csrc/dense_group.cu kMaxKinds


def _dg_launch_groups(kinds: Sequence[str], G: int) -> List[List[int]]:
    """Split kind indices into launches of at most ``_DG_MAX_KINDS`` kinds
    whose shared memory, 4 * G * (1 + outputs) bytes, fits
    ``_DG_SMEM_BUDGET``."""
    groups: List[List[int]] = []
    used = 0
    for i, k in enumerate(kinds):
        need = 4 * G * _DG_ARITY[k][1]
        if not groups or len(groups[-1]) == _DG_MAX_KINDS or \
                used + need > _DG_SMEM_BUDGET:
            groups.append([])
            used = 4 * G
        if used + need > _DG_SMEM_BUDGET:
            raise ValueError(f"kind {k!r} at G={G} exceeds shared memory")
        groups[-1].append(i)
        used += need
    return groups


def _check_dg(gid, inputs, kinds, G):
    _require(G % 128 == 0 and G > 0, f"G must be a multiple of 128: {G}")
    _require(all(k in _DG_ARITY for k in kinds), f"unknown kind in {kinds}")
    _require(len(inputs) == sum(_DG_ARITY[k][0] for k in kinds),
             f"{len(inputs)} inputs for kinds {kinds}")
    _require(gid.ndim == 1 and gid.dtype == torch.int32, "gid must be (n,) "
             "int32")
    ij = 0
    for k in kinds:
        want = torch.float32 if k in _DG_F32 else torch.int32
        for x in inputs[ij:ij + _DG_ARITY[k][0]]:
            _require(x.shape == gid.shape and x.dtype == want,
                     f"input of kind {k!r} must be ({gid.shape[0]},) {want}")
        ij += _DG_ARITY[k][0]


def dense_group_reduce_plain(gid: torch.Tensor, inputs, kinds: tuple,
                             G: int):
    """Plain version: index_add / scatter_reduce per kind into G + 1 slots
    (slot G takes every row outside [0, G) and is dropped)."""
    dev = gid.device
    slot = torch.where((gid >= 0) & (gid < G), gid, G).long()

    def acc(x, init, reduce=None):
        buf = torch.full((G + 1,), init, dtype=x.dtype, device=dev)
        if reduce is None:
            return buf.index_add_(0, slot, x)[:G]
        return buf.scatter_reduce_(0, slot, x, reduce)[:G]

    rows = acc(torch.ones_like(gid), 0)
    outs = []
    ij = 0
    for kind in kinds:
        x = inputs[ij]
        if kind in ("sum", "count"):
            outs.append(acc(x, 0))
        elif kind in ("min", "max", "imin", "imax"):
            # scatter_reduce amin/amax propagate NaN (CPU and CUDA), as
            # jnp.min / jnp.max do
            outs.append(acc(x, _DG_IDENT[kind],
                            "amin" if "min" in kind else "amax"))
        elif kind == "sumc":
            t = acc(x.long() & _U32, 0)
            # int64 -> int32 keeps the low 32 bits (u32 bits in an i32)
            outs += [(t & _U32).to(torch.int32), (t >> 32).to(torch.int32)]
        else:                                   # imin64 / imax64
            key = (inputs[ij].long() << 32) | \
                ((inputs[ij + 1].long() & _U32) ^ _BIAS32)
            is_min = kind == "imin64"
            r = acc(key, _I64MAX if is_min else _I64MIN,
                    "amin" if is_min else "amax")
            outs += [(r >> 32).to(torch.int32),
                     ((r & _U32) ^ _BIAS32).to(torch.int32)]
        ij += _DG_ARITY[kind][0]
    return rows, outs


def dense_group_reduce(gid: torch.Tensor, inputs, kinds: tuple, G: int):
    """Dense-domain grouped reduction (the TPU kernel's contract).

    gid: (n,) int32 slot per row; rows outside [0, G) are ignored
      (negative = inactive).
    inputs: per kind, (n,) float32 for sum/min/max, int32 otherwise;
      pre-masked by the caller (inactive rows hold the op identity).
    kinds: "sum"|"min"|"max"|"count"|"imin"|"imax" (one input, one output),
      "sumc" (16-bit limbs -> (u32-wrap lo, carry)), "imin64"/"imax64"
      ((hi, biased lo) pairs -> their lexicographic min/max pair).
    G: slot count, a multiple of 128.

    Returns (rows (G,) int32 active-row count per slot, [outputs (G,)]);
    empty slots hold each kind's identity."""
    kinds = tuple(kinds)
    inputs = tuple(inputs)
    _check_dg(gid, inputs, kinds, G)
    if _on_cpu((gid,) + inputs):
        return dense_group_reduce_plain(gid, inputs, kinds, G)
    _require(all(t.is_contiguous() for t in (gid,) + inputs),
             "dense_group_reduce needs contiguous tensors")
    lib = _lib()
    dev = gid.device
    n = gid.shape[0]
    rows = torch.empty((G,), dtype=torch.int32, device=dev)
    # per kind: its input tensors and its output tensors
    ins, outs_of = [], []
    ij = 0
    for k in kinds:
        ni, no = _DG_ARITY[k]
        ins.append(inputs[ij:ij + ni])
        dtype = torch.float32 if k in _DG_F32 else torch.int32
        outs_of.append([torch.empty((G,), dtype=dtype, device=dev)
                        for _ in range(no)])
        ij += ni
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        for gi, group in enumerate(_dg_launch_groups(kinds, G)):
            nk = len(group)
            codes = (ctypes.c_int * nk)(*[_DG_KINDS[kinds[i]] for i in group])
            in0, in1, out0, out1 = ((ctypes.c_int64 * nk)() for _ in range(4))
            ws_bytes = 4 * G
            for j, i in enumerate(group):
                in0[j] = ins[i][0].data_ptr()
                in1[j] = ins[i][-1].data_ptr()
                out0[j] = outs_of[i][0].data_ptr()
                out1[j] = outs_of[i][-1].data_ptr()
                ws_bytes += 4 * G * len(outs_of[i])
            ws = torch.empty((ws_bytes,), dtype=torch.uint8, device=dev)
            _check_rc(lib.atp_dense_group_reduce(
                gid.data_ptr(), n, G, nk, codes, in0, in1, out0, out1,
                rows.data_ptr() if gi == 0 else None, ws.data_ptr(),
                ws_bytes, stream), "dense_group_reduce")
    LAUNCHES["dense_group_reduce"] += 1
    return rows, [o for os_ in outs_of for o in os_]
