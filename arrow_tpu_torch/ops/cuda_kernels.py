"""Hand-written CUDA kernels for Hopper, their wrappers and plain versions.

The counterpart of the JAX package's ``ops/pallas_kernels.py`` for the
kernels on the filter -> group-by paths, the exchange and the join; seven
kernels:

  * ``filter_compact_columns`` (csrc/filter_compact.cu): stream compaction
    of a batch's columns, each as it lies, in one launch;
    ``filter_compact_chunks`` is its one-column form on (cap, C) u8 byte
    planes, the TPU function's contract;
  * ``tile_compact_local`` (csrc/tile_compact.cu): per 1024-row tile, the
    local indices of the selected rows packed to the front, and their count
    (level 1 of the take-index filter);
  * ``tile_stitch`` (csrc/tile_compact.cu): every tile's local indices to
    their place in the output as global take indices (level 2; the JAX
    package does it with a scan and gathers because the TPU cannot
    scatter, which is this kernel's plain version);
  * ``dense_group_reduce`` (csrc/dense_group.cu): per-slot reductions over a
    dense group id: the TPU kernel's nine kinds over 32-bit streams, and
    the card's native ones ("sum64", "min64", "max64" over an int64
    stream, "first_row", "any8" / "all8" over a bool column's bytes, a
    validity stream per kind); the slot of a row
    is given (a gid) or formed in the kernel from the key column
    (``DenseKey``);
  * ``partition_histogram_segments`` (csrc/partition_hist.cu): rows per
    destination of an exchange, for every shard of a device in one launch
    (``partition_histogram`` is its one-shard form, the TPU function), and
    each tile's offsets per destination;
  * ``partition_positions`` (csrc/partition_hist.cu): from those offsets,
    every row's slot in its destination's bucket (the stable sort by
    destination of the JAX package's exchange, and its position passes);
  * ``pack_key_lanes`` (csrc/pack_lanes.cu): the hash join's key lanes
    range-packed into one 32-bit word per row (the JAX package leaves these
    elementwise passes to XLA's fusion; torch runs each as a launch).

Each wrapper takes the plain PyTorch version (``*_plain``, same module) only
when its tensors lie on the CPU. CUDA tensors launch the kernel or raise;
nothing falls back. ``LAUNCHES`` counts kernel launches per wrapper, so a
run can show that its path went through the kernels.

Calls may be captured into a CUDA graph (``capture_graph``): a captured B1
call takes a scratch of its own that its launch clears (a replay cannot
renew the epoch and ticket base an eager call takes from ``_fc_scratch``),
and a captured histogram call a ticket buffer of its own that the graph
zeroes; neither touches the per-stream buffers of eager calls. A capture
adds nothing to ``LAUNCHES``; each replay adds the launches its graph
holds.

The sources build at first use with nvcc into ``<repo>/.kernels_build/``
(one compile per source, all started together, linked into one shared
library with a plain C interface and loaded with ctypes), keyed by a hash
of the sources and flags.
"""

from __future__ import annotations

import contextlib
import ctypes
import hashlib
import os
import shutil
import struct
import subprocess
from pathlib import Path
from typing import List, NamedTuple, Optional, Sequence, Tuple, Union

import torch

from .bits import float_extreme_key, float_from_extreme_key
from .segment import rows_of_positions

__all__ = ["filter_compact_columns", "filter_compact_columns_plain",
           "filter_compact_chunks", "filter_compact_chunks_plain",
           "tile_compact_local", "tile_compact_local_plain",
           "tile_stitch", "tile_stitch_plain",
           "DenseKey", "dense_key_gid",
           "dense_group_reduce", "dense_group_reduce_plain",
           "partition_histogram", "partition_histogram_plain",
           "partition_histogram_segments",
           "partition_histogram_segments_plain",
           "partition_positions", "partition_positions_plain",
           "pack_key_lanes", "pack_key_lanes_plain", "build",
           "LAUNCHES", "reset_launch_counts", "capture_graph",
           "CapturedGraph", "TILE_ROWS", "MAX_PARTITIONS",
           "MAX_SEGMENTS", "PH_TILE_ROWS",
           "MAX_PACK_LANES", "PACK_MISS", "FC_MAX_COLUMNS", "FC_TILE_ROWS"]

_CSRC = Path(__file__).resolve().parent.parent / "csrc"
_BUILD_DIR = Path(__file__).resolve().parents[2] / ".kernels_build"
_NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
               "-O3", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

# kernel launches per wrapper (only where the wrapper launches its kernel);
# "filter_compact_chunks" counts every launch of the filter kernel, from
# filter_compact_columns and filter_compact_chunks alike
LAUNCHES = {"filter_compact_chunks": 0, "tile_compact_local": 0,
            "tile_stitch": 0, "dense_group_reduce": 0,
            "partition_histogram": 0, "partition_positions": 0,
            "pack_key_lanes": 0}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---- CUDA graphs ---------------------------------------------------------------

# the buffers the wrappers allocate for the capture in progress (B1's
# scratch, the histogram's tickets): kept with its graph
_captured = []


class CapturedGraph:
    """A captured ``torch.cuda.CUDAGraph``, what its function returned
    (static tensors that each replay rewrites), the kernel launches it
    holds and the buffers its captured calls own."""

    def __init__(self, graph, output, launches, buffers):
        self.graph = graph
        self.output = output
        self.launches = launches
        self.buffers = buffers

    def replay(self):
        """Replay the graph on the current stream; adds its launches to
        ``LAUNCHES``. Returns the output."""
        self.graph.replay()
        for name, n in self.launches.items():
            LAUNCHES[name] += n
        return self.output


def capture_graph(fn) -> CapturedGraph:
    """Capture ``fn()`` into a CUDA graph (``torch.cuda.graph``, its own
    memory pool): nothing runs until ``replay``. The tensors ``fn`` reads
    are read again, where they lie, by every replay. A capture that fails
    raises; nothing falls back. The capture checks only this thread's CUDA
    calls: another thread's work meanwhile (a prefetching producer) does
    not break it."""
    before = dict(LAUNCHES)
    _captured.clear()
    graph = torch.cuda.CUDAGraph()
    try:
        with torch.cuda.graph(graph, capture_error_mode="thread_local"):
            output = fn()
    finally:
        buffers = list(_captured)
        _captured.clear()
        held = {k: LAUNCHES[k] - before[k] for k in LAUNCHES}
        for k, n in held.items():
            LAUNCHES[k] -= n        # a capture launches nothing
    return CapturedGraph(graph, output,
                         {k: n for k, n in held.items() if n}, buffers)


def _capturing() -> bool:
    return torch.cuda.is_current_stream_capturing()


def keep_for_capture(t: torch.Tensor) -> torch.Tensor:
    """``t`` kept alive with the graph being captured (a buffer a captured
    call owns, a pinned buffer a captured copy reads at every replay)."""
    _captured.append(t)
    return t


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


def _library_path() -> Tuple[Path, str]:
    """(the shared library's path, its tag): keyed by the flags and the
    sources' hash."""
    h = hashlib.sha256(" ".join(_NVCC_FLAGS).encode())
    for s in sorted(_CSRC.glob("*.cu")) + sorted(_CSRC.glob("*.cuh")):
        h.update(s.name.encode())
        h.update(s.read_bytes())
    tag = h.hexdigest()[:16]
    return _BUILD_DIR / f"libarrow_tpu_torch_{tag}.so", tag


def is_built() -> bool:
    """Whether the library of the current sources is built (or loaded)."""
    return _lib_handle is not None or _library_path()[0].is_file()


def build() -> Tuple[Path, str]:
    """Compile csrc/*.cu into one shared library if it is not built yet:
    one nvcc per source, all started together, then one link. Returns
    (library path, compiler output — empty when already built)."""
    sources = sorted(_CSRC.glob("*.cu"))
    lib, tag = _library_path()
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
            "atp_fc_max_columns": [],
            "atp_filter_compact": [vp, i64, ctypes.c_char_p, i32, vp, vp,
                                   i64, ctypes.c_uint64, i64, vp, vp],
            "atp_tc_tile_rows": [],
            "atp_tile_compact_local": [vp, i64, vp, vp, vp],
            "atp_tile_stitch": [vp, vp, vp, i64, i64, vp, vp],
            "atp_dense_group_reduce": [vp, i64, i32, i32, p_i32, p_i64,
                                       p_i64, p_i64, p_i64, p_i64, vp, i32,
                                       vp, i64, vp, i64, vp, vp, i64, vp],
            "atp_ph_max_partitions": [],
            "atp_ph_max_segments": [],
            "atp_ph_tile_rows": [],
            "atp_partition_histogram": [ctypes.c_char_p, i32, i32, vp, vp,
                                        vp, vp],
            "atp_partition_positions": [ctypes.c_char_p, i32, i32, i64, vp,
                                        vp, vp],
            "atp_pl_max_lanes": [],
            "atp_pack_key_lanes": [p_i64, p_i64, i32, vp, vp, vp, vp, i64,
                                   vp, vp],
        }
        for name, argtypes in sigs.items():
            fn = getattr(lib, name)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
        if (lib.atp_ph_max_partitions(), lib.atp_ph_max_segments(),
                lib.atp_ph_tile_rows()) != (MAX_PARTITIONS, MAX_SEGMENTS,
                                            PH_TILE_ROWS):
            raise RuntimeError("csrc/partition_hist.cu and MAX_PARTITIONS / "
                               "MAX_SEGMENTS / PH_TILE_ROWS disagree")
        if lib.atp_pl_max_lanes() != MAX_PACK_LANES:
            raise RuntimeError(
                "csrc/pack_lanes.cu and MAX_PACK_LANES disagree")
        if (lib.atp_fc_tile_rows(), lib.atp_fc_max_columns()) != (
                FC_TILE_ROWS, FC_MAX_COLUMNS):
            raise RuntimeError("csrc/filter_compact.cu and FC_TILE_ROWS / "
                               "FC_MAX_COLUMNS disagree")
        if lib.atp_tc_tile_rows() != TILE_ROWS:
            raise RuntimeError(
                "csrc/tile_compact.cu and TILE_ROWS disagree")
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


def _device_stream(dev: torch.device):
    """(a context that makes ``dev`` the current device, a no-op where it
    is already; ``dev``'s current stream as a pointer): less host time a
    call than ``torch.cuda.current_stream(dev)`` inside
    ``torch.cuda.device(dev)``."""
    idx = dev.index if dev.index is not None else torch.cuda.current_device()
    ctx = contextlib.nullcontext() if idx == torch.cuda.current_device() \
        else torch.cuda.device(idx)
    return ctx, torch._C._cuda_getCurrentRawStream(idx)


# ---- filter_compact_columns / filter_compact_chunks --------------------------

FC_MAX_COLUMNS = 32     # csrc/filter_compact.cu kMaxCols: columns a launch
FC_TILE_ROWS = 8192     # csrc/filter_compact.cu kTile: rows a block
_FC_EPOCHS = 1 << 30    # a status word's epoch has 30 bits
# Per (device index, stream): [scratch of 1 + tiles int64 words (the ticket,
# then one status word a tile), the last call's epoch, the tickets taken
# since the last clear]. Calls on one stream run in order and share the
# buffer: the epoch tells a call's status words from an earlier call's, so
# the buffer is cleared only when it grows or the epoch wraps.
_fc_scratch = {}
_FC_MAX_ROW_BYTES = 1 << 16     # csrc/filter_compact.cu kMaxRowBytes
_SIGNED = {1: torch.int8, 2: torch.int16, 4: torch.int32, 8: torch.int64}


def _fc_width(col: torch.Tensor, cap: int) -> int:
    """Bytes a row of a column the kernel takes; raises on any other (the
    messages are built only then: this runs per column and call)."""
    if col.ndim == 1:
        width = col.element_size()
        if width not in _SIGNED:
            raise ValueError(f"no filter kernel for {col.dtype} columns")
    elif col.ndim == 2 and col.dtype == torch.uint8 and (
            col.stride(1) == 1 or col.shape[1] <= 1):
        width = col.shape[1]
    else:
        raise ValueError("a column must be (cap,) of 1, 2, 4 or 8-byte "
                         "elements or (cap, C) uint8 with contiguous rows")
    if col.shape[0] != cap:
        raise ValueError(f"a column has {col.shape[0]} rows, the selection "
                         f"{cap}")
    if width > _FC_MAX_ROW_BYTES or \
            col.stride(0) * col.element_size() > _FC_MAX_ROW_BYTES:
        raise ValueError(f"a column's rows and row stride must be at most "
                         f"{_FC_MAX_ROW_BYTES} bytes")
    return width


def filter_compact_columns_plain(sel: torch.Tensor, columns):
    """Plain version: per column one scatter of the selected rows to their
    ranks (the dump row ``cap`` takes the rest; rows past the count are
    zero), through a signed view of the same width (the card has no
    index_copy for uint16 / uint32 / uint64); the count is ``sel.sum()``."""
    cap = sel.shape[0]
    dst = torch.where(sel, torch.cumsum(sel, 0) - 1, cap)
    outs = []
    for col in columns:
        flat = col if col.ndim == 2 else col.view(_SIGNED[col.element_size()])
        out = flat.new_zeros((cap + 1,) + tuple(flat.shape[1:]))
        out.index_copy_(0, dst, flat)
        outs.append(out[:cap].view(col.dtype))
    return outs, torch.sum(sel, dtype=torch.int32)


def _fc_scratch_for(dev: torch.device, stream: int, tiles: int):
    """(scratch, epoch, ticket base, bytes to clear first) for a call of
    ``tiles`` tiles on ``stream``."""
    key = (dev.index, stream)
    s = _fc_scratch.get(key)
    if s is None or s[0].shape[0] < tiles + 1:
        size = tiles + 1 if s is None else max(tiles + 1, 2 * s[0].shape[0])
        s = _fc_scratch[key] = [
            torch.zeros((size,), dtype=torch.int64, device=dev), 0, 0]
    s[1] += 1
    reset = 0
    if s[1] == _FC_EPOCHS:          # the epoch wraps: clear every word
        s[1], s[2], reset = 1, 0, 8 * s[0].shape[0]
    base = s[2]
    s[2] += tiles
    return s[0], s[1], base, reset


def filter_compact_columns(sel: torch.Tensor, columns):
    """(cap,) bool selection + columns -> (outputs, count): for each column
    a new contiguous tensor of its shape and dtype whose first ``count``
    rows are the selected rows in order (rows past the count unspecified),
    and ``count`` the number of selected rows as a 0-d int32 on the device.

    A column is a (cap,) tensor of 1, 2, 4 or 8-byte elements at any stride
    (bool columns move as bytes) or a (cap, C) uint8 matrix whose rows are
    contiguous; any cap works. One kernel launch compacts up to
    ``FC_MAX_COLUMNS`` columns (wider batches take one more launch for each
    further group), with no torch pass between launches and nothing read
    on the host."""
    columns = list(columns)
    _require(sel.ndim == 1 and sel.dtype == torch.bool,
             "sel must be (cap,) bool")
    cap = sel.shape[0]
    widths = [_fc_width(c, cap) for c in columns]
    if _on_cpu([sel] + columns):
        return filter_compact_columns_plain(sel, columns)
    _require(sel.stride(0) == 1 or cap <= 1, "sel must be contiguous")
    _require(cap < (1 << 31), "counts are int32: cap must be < 2^31")
    dev = sel.device
    outs = [torch.empty(c.shape, dtype=c.dtype, device=dev) for c in columns]
    if cap == 0:
        return outs, torch.zeros((), dtype=torch.int32, device=dev)
    lib = _lib()
    count = torch.empty((), dtype=torch.int32, device=dev)
    tiles = -(-cap // FC_TILE_ROWS)
    launches = max(1, -(-len(columns) // FC_MAX_COLUMNS))
    starts = torch.empty((tiles,), dtype=torch.int32, device=dev) \
        if launches > 1 else None
    desc = struct.pack(f"<{4 * len(columns)}q", *[
        v for c, o, w in zip(columns, outs, widths)
        for v in (c.data_ptr(), o.data_ptr(), c.stride(0) * c.element_size(),
                  w)])
    ctx, stream = _device_stream(dev)
    if _capturing():
        # a graph replays this launch with its parameters frozen: a scratch
        # of its own, cleared by every launch, at epoch 1 and ticket base 0
        scratch = keep_for_capture(torch.empty((tiles + 1,),
                                               dtype=torch.int64, device=dev))
        epoch, base, reset = 1, 0, 8 * (tiles + 1)
    else:
        scratch, epoch, base, reset = _fc_scratch_for(dev, stream, tiles)
    with ctx:
        rc = lib.atp_filter_compact(
            sel.data_ptr(), cap, desc, len(columns), count.data_ptr(),
            scratch.data_ptr(), epoch, base, reset,
            None if starts is None else starts.data_ptr(), stream)
    if rc != 0:
        if not _capturing():
            _fc_scratch.pop((dev.index, stream), None)  # its state is unknown
        _check_rc(rc, "filter_compact_columns")
    LAUNCHES["filter_compact_chunks"] += launches
    return outs, count


def filter_compact_chunks_plain(sel: torch.Tensor,
                                chunks: torch.Tensor) -> torch.Tensor:
    """Plain version of the one-matrix form (rows past the count zero)."""
    return filter_compact_columns_plain(sel, [chunks])[0][0]


def filter_compact_chunks(sel: torch.Tensor,
                          chunks: torch.Tensor) -> torch.Tensor:
    """(cap,) bool selection + (cap, C) u8 byte planes -> (cap, C) u8 with
    the selected rows packed to the front in order; rows past the count
    are unspecified (callers track the count). Any cap works. The TPU
    function's form: ``filter_compact_columns`` with one column C bytes
    wide."""
    _require(chunks.ndim == 2 and chunks.dtype == torch.uint8,
             "chunks must be (cap, C) uint8")
    _require(sel.shape == chunks.shape[:1] and sel.dtype == torch.bool,
             "sel must be (cap,) bool")
    (out,), _ = filter_compact_columns(sel, [chunks])
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
    tile's count hold 0), and the tile's selected count. ``tile_stitch``
    (level 2) turns them into take indices. A view that starts at any byte
    is taken as it is (the kernel reads it with 1-byte loads when its
    address is not a multiple of 16)."""
    _check_tc(sel)
    if _on_cpu((sel,)):
        return tile_compact_local_plain(sel)
    _require(sel.is_contiguous(), "tile_compact_local needs a contiguous "
             "tensor")
    lib = _lib()
    cap = sel.shape[0]
    dev = sel.device
    loc = torch.empty((cap,), dtype=torch.int32, device=dev)
    counts = torch.empty((cap // TILE_ROWS,), dtype=torch.int32, device=dev)
    ctx, stream = _device_stream(dev)
    with ctx:
        _check_rc(lib.atp_tile_compact_local(
            sel.data_ptr(), cap, loc.data_ptr(), counts.data_ptr(), stream),
            "tile_compact_local")
    LAUNCHES["tile_compact_local"] += 1
    return loc, counts


# ---- tile_stitch --------------------------------------------------------------

def _check_ts(loc, counts, starts, out_cap: int) -> int:
    T = counts.shape[0]
    _require(T >= 1 and loc.shape == (T * TILE_ROWS,) and
             starts.shape == (T + 1,),
             "loc (T * 1024,), counts (T,), starts (T + 1,) with T >= 1")
    _require(loc.dtype == counts.dtype == starts.dtype == torch.int32,
             "loc, counts and starts must be int32")
    _require(0 <= out_cap < (1 << 31) and loc.shape[0] < (1 << 31),
             "indices are int32: capacities must be < 2^31")
    return T


def tile_stitch_plain(loc: torch.Tensor, counts: torch.Tensor,
                      starts: torch.Tensor, out_cap: int) -> torch.Tensor:
    """Plain version, the gather form of the JAX package's level 2 (the
    TPU cannot scatter): ``rows_of_positions`` sends every output position
    to its source tile, and two gathers (the tile's start, the tile-local
    index) give the global index. ``counts`` is implied by ``starts``."""
    T = _check_ts(loc, counts, starts, out_cap)
    tile_of = rows_of_positions(starts, out_cap).clamp_(0, T - 1)
    j = torch.arange(out_cap, dtype=torch.int32, device=loc.device)
    within = (j - starts[tile_of.long()]).clamp_(0, TILE_ROWS - 1)
    base = tile_of * TILE_ROWS
    del tile_of
    indices = base + loc[(base + within).long()]
    return torch.where(j < starts[-1], indices, 0)


def tile_stitch(loc: torch.Tensor, counts: torch.Tensor,
                starts: torch.Tensor, out_cap: int) -> torch.Tensor:
    """Level 2 of the take-index filter: ``tile_compact_local``'s (loc,
    counts) and ``starts`` (T + 1,) int32, the exclusive prefix sum of
    counts with the total last -> indices (out_cap,) int32 with
    ``indices[starts[t] + r] = t * 1024 + loc[t * 1024 + r]`` for
    ``r < counts[t]`` and 0 from ``starts[T]`` to ``out_cap`` (so a take
    through padding rows stays in range). ``out_cap`` must hold the total;
    nothing is read on the host."""
    T = _check_ts(loc, counts, starts, out_cap)
    if _on_cpu((loc, counts, starts)):
        return tile_stitch_plain(loc, counts, starts, out_cap)
    _require(loc.is_contiguous() and counts.is_contiguous() and
             starts.is_contiguous(), "tile_stitch needs contiguous tensors")
    lib = _lib()
    dev = loc.device
    indices = torch.empty((out_cap,), dtype=torch.int32, device=dev)
    ctx, stream = _device_stream(dev)
    with ctx:
        _check_rc(lib.atp_tile_stitch(
            loc.data_ptr(), counts.data_ptr(), starts.data_ptr(), T, out_cap,
            indices.data_ptr(), stream), "tile_stitch")
    LAUNCHES["tile_stitch"] += 1
    return indices


# ---- dense_group_reduce ------------------------------------------------------

# kind -> (#inputs, #outputs) and the identity an empty slot keeps. The
# first nine are the TPU kernel's (pallas_kernels.py _DG_IDENT / _DG_ARITY),
# over 32-bit streams; the last six are this card's native kinds: one int64
# stream for "sum64" / "min64" / "max64", none for "first_row", one bool
# stream (a byte a row) for "any8" / "all8", whose outputs are int32 0 / 1.
_I64MAX = (1 << 63) - 1
_I64MIN = -(1 << 63)
_DG_IDENT = {
    "sum": 0.0, "min": float("inf"), "max": float("-inf"),
    "imin": (1 << 31) - 1, "imax": -(1 << 31), "count": 0, "sumc": 0,
    "sum64": 0, "min64": _I64MAX, "max64": _I64MIN,
    "first_row": (1 << 31) - 1, "any8": 0, "all8": 1,
}
_DG_ARITY = {
    "sum": (1, 1), "min": (1, 1), "max": (1, 1), "imin": (1, 1),
    "imax": (1, 1), "count": (1, 1), "sumc": (1, 2),
    "imin64": (2, 2), "imax64": (2, 2),
    "sum64": (1, 1), "min64": (1, 1), "max64": (1, 1), "first_row": (0, 1),
    "any8": (1, 1), "all8": (1, 1),
}
# kind codes of csrc/dense_group.cu
_DG_KINDS = {"sum": 0, "min": 1, "max": 2, "imin": 3, "imax": 4,
             "count": 5, "sumc": 6, "imin64": 7, "imax64": 8,
             "sum64": 9, "min64": 10, "max64": 11, "first_row": 12,
             "any8": 13, "all8": 14}
_DG_F32 = ("sum", "min", "max")
_DG_I64 = ("sum64", "min64", "max64")
_DG_BOOL = ("any8", "all8")
# kinds whose accumulator takes 8 bytes a slot (csrc/dense_group.cu wide())
_DG_WIDE = ("sumc", "imin64", "imax64") + _DG_I64
_BIAS32 = 0x80000000
_U32 = 0xFFFFFFFF
# Shared memory one launch may use: all a block can have on an H100 (the
# kernel runs one block of 1024 threads an SM above half of it, two of 512
# below). Kinds past it go to another launch.
_DG_SMEM_BUDGET = 227 * 1024
_DG_MAX_KINDS = 16          # csrc/dense_group.cu kMaxKinds
# Rows of a warp's 128-row step in one slot from which the kernel combines
# them with shuffles before the atomic (above 128: never). Uniform keys stay
# far below it; ``bench_reductions`` times the kernel with and without.
_DG_HOT_ROWS = 16


class DenseKey(NamedTuple):
    """Where ``dense_group_reduce`` takes the slots from a key column in
    place of a ready ``gid``: row r lies in slot ``values[r] - lo`` (its low
    32 bits as an int32), in the null-key slot G - 1 where ``validity[r]``
    is False, and in none (-1) where r >= ``length``. The kernel forms the
    slot as it reads the row, which saves the elementwise passes that
    build a gid."""
    values: torch.Tensor                    # (n,) int64
    lo: int
    length: Union[int, torch.Tensor]        # rows in use: int or 0-d tensor
    validity: Optional[torch.Tensor]        # (n,) bool, or None


def dense_key_gid(key: DenseKey, G: int) -> torch.Tensor:
    """The (n,) int32 gid a ``DenseKey`` stands for, in plain PyTorch."""
    n = key.values.shape[0]
    in_range = torch.arange(n, device=key.values.device) < key.length
    gid = torch.where(in_range, (key.values - key.lo).to(torch.int32), -1)
    if key.validity is not None:
        gid = torch.where(key.validity | ~in_range, gid, G - 1)
    return gid


def _dg_dtype(kind: str) -> torch.dtype:
    """dtype of a kind's outputs, and of its input streams but for the
    bool kinds' (``_dg_in_dtype``)."""
    if kind in _DG_F32:
        return torch.float32
    return torch.int64 if kind in _DG_I64 else torch.int32


def _dg_in_dtypes(kind: str) -> tuple:
    """dtypes a kind's input streams may have: a bool kind's stream is a
    bool column, or an int32 stream whose nonzero entries are True."""
    return (torch.bool, torch.int32) if kind in _DG_BOOL \
        else (_dg_dtype(kind),)


def _bool_streams(inputs: tuple, kinds: tuple) -> tuple:
    """``inputs`` with each bool kind's int32 stream made a bool one (the
    kernel reads a byte a row; a bool column needs no pass)."""
    out, ij = list(inputs), 0
    for k in kinds:
        if k in _DG_BOOL and out[ij].dtype != torch.bool:
            out[ij] = out[ij] != 0
        ij += _DG_ARITY[k][0]
    return tuple(out)


def _dg_acc_bytes(kind: str, G: int) -> int:
    return G * (8 if kind in _DG_WIDE else 4)


def _dg_launch_groups(kinds: Sequence[str], G: int) -> List[List[int]]:
    """Split kind indices into launches of at most ``_DG_MAX_KINDS`` kinds
    whose shared memory (4 * G bytes of row counts + each kind's
    accumulators) fits ``_DG_SMEM_BUDGET``."""
    groups: List[List[int]] = []
    used = 0
    for i, k in enumerate(kinds):
        need = _dg_acc_bytes(k, G)
        if not groups or len(groups[-1]) == _DG_MAX_KINDS or \
                used + need > _DG_SMEM_BUDGET:
            groups.append([])
            used = 4 * G
        if used + need > _DG_SMEM_BUDGET:
            raise ValueError(f"kind {k!r} at G={G} exceeds shared memory")
        groups[-1].append(i)
        used += need
    return groups or [[]]       # no kinds: one launch for the row counts


def _check_dg(gid, inputs, kinds, G, valid):
    _require(G % 128 == 0 and G > 0, f"G must be a multiple of 128: {G}")
    _require(all(k in _DG_ARITY for k in kinds), f"unknown kind in {kinds}")
    _require(len(inputs) == sum(_DG_ARITY[k][0] for k in kinds),
             f"{len(inputs)} inputs for kinds {kinds}")
    if isinstance(gid, DenseKey):
        _require(gid.values.ndim == 1 and gid.values.dtype == torch.int64,
                 "DenseKey.values must be (n,) int64")
        _require(gid.validity is None or (
            gid.validity.shape == gid.values.shape and
            gid.validity.dtype == torch.bool),
            "DenseKey.validity must be (n,) bool")
        _require(-(1 << 63) <= gid.lo < (1 << 63), "DenseKey.lo must fit "
                 "int64")
        gid = gid.values
    else:
        _require(gid.ndim == 1 and gid.dtype == torch.int32, "gid must be "
                 "(n,) int32")
    _require(gid.shape[0] < (1 << 31), "row indices are int32: n must be "
             "< 2^31")
    _require(len(valid) == len(kinds), "one validity entry (or None) per "
             "kind")
    ij = 0
    for k, v in zip(kinds, valid):
        for x in inputs[ij:ij + _DG_ARITY[k][0]]:
            _require(x.shape == gid.shape and x.dtype in _dg_in_dtypes(k),
                     f"input of kind {k!r} must be ({gid.shape[0]},) "
                     f"{' or '.join(map(str, _dg_in_dtypes(k)))}")
        _require(v is None or (v.shape == gid.shape and
                               v.dtype == torch.bool),
                 f"validity of kind {k!r} must be ({gid.shape[0]},) bool")
        ij += _DG_ARITY[k][0]


def dense_group_reduce_plain(gid, inputs, kinds: tuple, G: int, valid=None):
    """Plain version: index_add / scatter_reduce per kind into G + 1 slots
    (slot G takes every row outside [0, G), and for a kind with a validity
    stream its invalid rows, and is dropped)."""
    if isinstance(gid, DenseKey):
        gid = dense_key_gid(gid, G)
    dev = gid.device
    slot = torch.where((gid >= 0) & (gid < G), gid, G).long()
    valid = (None,) * len(kinds) if valid is None else valid

    def acc(x, init, reduce=None, at=slot):
        buf = torch.full((G + 1,), init, dtype=x.dtype, device=dev)
        if reduce is None:
            return buf.index_add_(0, at, x)[:G]
        return buf.scatter_reduce_(0, at, x, reduce)[:G]

    rows = acc(torch.ones_like(gid), 0)
    outs = []
    ij = 0
    for kind, v in zip(kinds, valid):
        at = slot if v is None else torch.where(v, slot, G)
        x = inputs[ij] if _DG_ARITY[kind][0] else None
        if kind in ("sum", "count", "sum64"):       # int64 adds wrap
            outs.append(acc(x, 0, at=at))
        elif kind in ("min", "max"):
            # NaN skipped, NaN alone kept: on order-preserving int32 keys
            is_min = kind == "min"
            k = acc(float_extreme_key(x, is_min), (1 << 31) - 1 if is_min
                    else -(1 << 31), "amin" if is_min else "amax", at=at)
            outs.append(float_from_extreme_key(k, is_min, torch.float32))
        elif kind in ("imin", "imax", "min64", "max64"):
            outs.append(acc(x, _DG_IDENT[kind],
                            "amin" if "min" in kind else "amax", at=at))
        elif kind in _DG_BOOL:
            outs.append(acc((x != 0).to(torch.int32), _DG_IDENT[kind],
                            "amax" if kind == "any8" else "amin", at=at))
        elif kind == "first_row":
            outs.append(acc(torch.arange(gid.shape[0], dtype=torch.int32,
                                         device=dev),
                            _DG_IDENT[kind], "amin", at=at))
        elif kind == "sumc":
            t = acc(x.long() & _U32, 0, at=at)
            # int64 -> int32 keeps the low 32 bits (u32 bits in an i32)
            outs += [(t & _U32).to(torch.int32), (t >> 32).to(torch.int32)]
        else:                                   # imin64 / imax64
            key = (inputs[ij].long() << 32) | \
                ((inputs[ij + 1].long() & _U32) ^ _BIAS32)
            is_min = kind == "imin64"
            r = acc(key, _I64MAX if is_min else _I64MIN,
                    "amin" if is_min else "amax", at=at)
            outs += [(r >> 32).to(torch.int32),
                     ((r & _U32) ^ _BIAS32).to(torch.int32)]
        ij += _DG_ARITY[kind][0]
    return rows, outs


def dense_group_reduce(gid, inputs, kinds: tuple, G: int, valid=None):
    """Dense-domain grouped reduction.

    gid: (n,) int32 slot per row; rows outside [0, G) are ignored
      (negative = inactive). Or a ``DenseKey``: the kernel forms the slot
      from the key column itself.
    kinds, with their input streams in ``inputs`` in order:
      "sum"|"min"|"max" (one float32 stream; min / max skip NaN, and a
      slot of NaNs alone gives NaN, as pyarrow's), "count"|"imin"|"imax" (one
      int32 stream), "sumc" (int32 stream of 16-bit limbs -> (u32-wrap lo,
      carry)), "imin64"/"imax64" ((hi, biased lo) int32 pair -> their
      lexicographic min/max pair): the TPU kernel's contract;
      "sum64" (one int64 stream, the sum mod 2^64), "min64"|"max64" (one
      int64 stream), "first_row" (no stream: the slot's least row index),
      "any8"|"all8" (one bool stream, or an int32 one whose nonzero
      entries are true -> int32 1 / 0: whether any / every valid row of
      the slot is true; 0 / 1 in a slot without one).
    valid: None, or per kind None or a (n,) bool stream: where it is False
      the row is skipped for that kind (it still counts in ``rows``). Two
      kinds may share a stream: the kernel reads it once a row.
    G: slot count, a multiple of 128.

    Returns (rows (G,) int32 active-row count per slot, [outputs (G,)]:
    float32 for sum/min/max, int64 for sum64/min64/max64, else int32);
    empty slots hold each kind's identity."""
    kinds = tuple(kinds)
    inputs = tuple(inputs)
    valid = (None,) * len(kinds) if valid is None else tuple(valid)
    _check_dg(gid, inputs, kinds, G, valid)
    inputs = _bool_streams(inputs, kinds)
    key = gid if isinstance(gid, DenseKey) else None
    tensors = inputs + tuple(v for v in valid if v is not None)
    if key is None:
        tensors += (gid,)
    else:
        tensors += tuple(t for t in key if isinstance(t, torch.Tensor))
    if _on_cpu(tensors):
        return dense_group_reduce_plain(gid, inputs, kinds, G, valid)
    _require(all(t.is_contiguous() for t in tensors),
             "dense_group_reduce needs contiguous tensors")
    lib = _lib()
    dev = tensors[-1].device
    n = (gid if key is None else key.values).shape[0]
    # where the slots come from: (gid, key, lo, length on the device,
    # length, key validity); the kernel reads a device length itself
    if key is None:
        slots = (gid.data_ptr(), None, 0, None, 0, None)
    else:
        on_device = isinstance(key.length, torch.Tensor)
        length = key.length.to(torch.int64) if on_device else None
        slots = (None, key.values.data_ptr(), key.lo,
                 length.data_ptr() if on_device else None,
                 0 if on_device else int(key.length),
                 None if key.validity is None else key.validity.data_ptr())
    rows = torch.empty((G,), dtype=torch.int32, device=dev)
    # per kind: its input tensors and its output tensors
    ins, outs_of = [], []
    ij = 0
    for k in kinds:
        ni, no = _DG_ARITY[k]
        ins.append(inputs[ij:ij + ni])
        outs_of.append([torch.empty((G,), dtype=_dg_dtype(k), device=dev)
                        for _ in range(no)])
        ij += ni
    ctx, stream = _device_stream(dev)
    with ctx:
        for gi, group in enumerate(_dg_launch_groups(kinds, G)):
            nk = len(group)
            codes = (ctypes.c_int * nk)(*[_DG_KINDS[kinds[i]] for i in group])
            in0, in1, vld, out0, out1 = ((ctypes.c_int64 * nk)()
                                         for _ in range(5))
            ws_bytes = 4 * G
            for j, i in enumerate(group):
                if ins[i]:
                    in0[j] = ins[i][0].data_ptr()
                    in1[j] = ins[i][-1].data_ptr()
                if valid[i] is not None:
                    vld[j] = valid[i].data_ptr()
                out0[j] = outs_of[i][0].data_ptr()
                out1[j] = outs_of[i][-1].data_ptr()
                ws_bytes += _dg_acc_bytes(kinds[i], G)
            ws = torch.empty((ws_bytes,), dtype=torch.uint8, device=dev)
            _check_rc(lib.atp_dense_group_reduce(
                slots[0], n, G, nk, codes, in0, in1, vld, out0, out1,
                rows.data_ptr() if gi == 0 else None, _DG_HOT_ROWS,
                *slots[1:],
                ws.data_ptr(), ws_bytes, stream), "dense_group_reduce")
    LAUNCHES["dense_group_reduce"] += 1
    return rows, [o for os_ in outs_of for o in os_]


# ---- partition_histogram / partition_positions -------------------------------

MAX_PARTITIONS = 128    # csrc/partition_hist.cu kMaxP: four bins per lane
MAX_SEGMENTS = 128      # csrc/partition_hist.cu kMaxSeg: segments a launch
PH_TILE_ROWS = 8192     # csrc/partition_hist.cu kTile: rows a block
# Per (device index, stream): the histogram's tickets, one int32 word a
# segment that is 0 between calls (the kernel's last block of the segment
# resets it). Calls on one stream run in order and share them.
_ph_tickets = {}


def _check_ph(dest: torch.Tensor, P: int) -> None:
    _require(dest.ndim == 1 and dest.dtype == torch.int32,
             "dest must be (n,) int32")
    _require(1 <= P <= MAX_PARTITIONS,
             f"P must be in [1, {MAX_PARTITIONS}]: {P}")
    _require(dest.shape[0] < (1 << 31), "counts are int32: n must be < 2^31")


def _check_segments(dests: Sequence[torch.Tensor], P: int) -> List[int]:
    """Checks the segments of a call; returns their lengths."""
    _require(1 <= len(dests) <= MAX_SEGMENTS,
             f"1 to {MAX_SEGMENTS} segments a call: {len(dests)}")
    for d in dests:
        _check_ph(d, P)
    sizes = [d.shape[0] for d in dests]
    _require(sum(sizes) < (1 << 31), "counts are int32: the rows of all "
             "segments must be < 2^31")
    return sizes


def _ph_tiles(sizes: Sequence[int]) -> int:
    """Tiles of a call: each segment cut into PH_TILE_ROWS-row tiles."""
    return sum(-(-n // PH_TILE_ROWS) for n in sizes)


def _ph_cuda_call(dests, sizes):
    """(device, the segments' descriptor: (address, rows) int64 pairs)."""
    _require(all(d.is_contiguous() for d in dests),
             "the exchange's kernels need contiguous dest tensors")
    desc = struct.pack(f"<{2 * len(dests)}q", *[
        v for d, n in zip(dests, sizes) for v in (d.data_ptr(), n)])
    return dests[0].device, desc


def partition_histogram_plain(dest: torch.Tensor, P: int) -> torch.Tensor:
    """Plain version: one bincount over P + 1 bins, the last taking every
    value outside [0, P)."""
    _check_ph(dest, P)
    d = dest.long()
    slot = torch.where((d >= 0) & (d < P), d, P)
    return torch.bincount(slot, minlength=P + 1)[:P].to(torch.int32)


def partition_histogram_segments_plain(dests, P: int):
    """Plain version: ``partition_histogram_plain`` once per segment; the
    tile offsets from one bincount over (tile, bin) a segment and a cumsum
    along its tiles."""
    dests = list(dests)
    sizes = _check_segments(dests, P)
    counts = torch.stack([partition_histogram_plain(d, P) for d in dests])
    offsets = []
    for d, n in zip(dests, sizes):
        d = d.long()
        slot = torch.where((d >= 0) & (d < P), d, P)
        tile = torch.arange(n, device=d.device) // PH_TILE_ROWS
        per = torch.bincount(tile * (P + 1) + slot,
                             minlength=-(-n // PH_TILE_ROWS) * (P + 1))
        per = per.view(-1, P + 1)[:, :P]
        offsets.append((torch.cumsum(per, 0) - per).T)
    return counts, torch.cat(offsets, 1).to(torch.int32)


def partition_histogram_segments(dests, P: int):
    """S (n_s,) int32 destination vectors (one a shard) -> (counts (S, P)
    int32, tile_offsets (P, T) int32), one kernel launch for all of them.

    ``counts[s]`` is ``partition_histogram(dests[s], P)``. The rows are cut
    into tiles of ``PH_TILE_ROWS`` rows, segment after segment (a segment's
    last tile may be short; T tiles in all), and ``tile_offsets[p, t]`` is
    the number of rows of tile t's segment before tile t whose dest is p:
    ``partition_positions`` starts from them. S is at most
    ``MAX_SEGMENTS``; no rows at all give zeros and launch nothing."""
    dests = list(dests)
    sizes = _check_segments(dests, P)
    if _on_cpu(dests):
        return partition_histogram_segments_plain(dests, P)
    dev, desc = _ph_cuda_call(dests, sizes)
    S, T = len(dests), _ph_tiles(sizes)
    if T == 0:
        return (torch.zeros((S, P), dtype=torch.int32, device=dev),
                torch.empty((P, 0), dtype=torch.int32, device=dev))
    lib = _lib()
    counts = torch.empty((S, P), dtype=torch.int32, device=dev)
    tiles = torch.empty((P, T), dtype=torch.int32, device=dev)
    ctx, stream = _device_stream(dev)
    key = (dev.index, stream)
    if _capturing():
        # tickets of the graph's own, zeroed by every replay (the kernel
        # resets them too: this does not rest on that)
        key = None
        ticket = keep_for_capture(torch.zeros((MAX_SEGMENTS,),
                                              dtype=torch.int32, device=dev))
    else:
        ticket = _ph_tickets.get(key)
    if ticket is None:
        ticket = _ph_tickets[key] = torch.zeros(
            (MAX_SEGMENTS,), dtype=torch.int32, device=dev)
    with ctx:
        rc = lib.atp_partition_histogram(desc, S, P, tiles.data_ptr(),
                                         counts.data_ptr(), ticket.data_ptr(),
                                         stream)
    if rc != 0:
        _ph_tickets.pop(key, None)      # its state is unknown
        _check_rc(rc, "partition_histogram")
    LAUNCHES["partition_histogram"] += 1
    return counts, tiles


def partition_histogram(dest: torch.Tensor, P: int) -> torch.Tensor:
    """(n,) int32 destinations -> (P,) int32 counts of dest == p for p in
    [0, P); values outside [0, P) are ignored (padding rows carry P or
    -1). P is at most ``MAX_PARTITIONS``; n = 0 gives zeros. The one-segment
    call of ``partition_histogram_segments``."""
    _check_ph(dest, P)
    if _on_cpu((dest,)):
        return partition_histogram_plain(dest, P)
    return partition_histogram_segments([dest], P)[0][0]


def partition_positions_plain(dests, P: int, B: int) -> List[torch.Tensor]:
    """Plain version, the exchange's arithmetic before this kernel: per
    segment a stable sort by dest, each sorted row's place in its run and
    its slot, put back in row order through the sort's permutation."""
    dests = list(dests)
    _check_segments(dests, P)
    _require(0 <= B < (1 << 31), f"B must be in [0, 2^31): {B}")
    outs = []
    for d in dests:
        d = torch.where((d >= 0) & (d < P), d, P)
        sd, perm = torch.sort(d, stable=True)
        sd = sd.long()
        counts = torch.bincount(sd, minlength=P + 1)
        pos_in_run = torch.arange(d.shape[0], device=d.device) - \
            (torch.cumsum(counts, 0) - counts)[sd]
        flat = torch.where((sd < P) & (pos_in_run < B), sd * B + pos_in_run,
                           P * B)
        outs.append(torch.empty_like(flat).index_copy_(0, perm, flat))
    return outs


def partition_positions(dests, P: int, B: int,
                        tile_offsets: torch.Tensor) -> List[torch.Tensor]:
    """Each row's slot in its segment's (P, B) send buffer, in row order:
    ``dest * B + rank`` where dest is in [0, P) and the row's stable rank
    among its segment's rows with the same dest is below B, else ``P * B``
    (the dump slot). ``tile_offsets`` is ``partition_histogram_segments``'
    second result for the same dests: the kernel starts from it (the plain
    version, which CPU tensors take, needs only the dests). Returns one
    (n_s,) int64 tensor a segment, views of one buffer; one kernel launch
    for all of them, none without rows."""
    dests = list(dests)
    sizes = _check_segments(dests, P)
    _require(0 <= B < (1 << 31), f"B must be in [0, 2^31): {B}")
    if _on_cpu(dests + [tile_offsets]):
        return partition_positions_plain(dests, P, B)
    dev, desc = _ph_cuda_call(dests, sizes)
    T = _ph_tiles(sizes)
    _require(tile_offsets.shape == (P, T) and
             tile_offsets.dtype == torch.int32 and
             tile_offsets.is_contiguous(),
             f"tile_offsets must be ({P}, {T}) contiguous int32: "
             "partition_histogram_segments' of the same dests")
    out = torch.empty((sum(sizes),), dtype=torch.int64, device=dev)
    if T:
        lib = _lib()
        ctx, stream = _device_stream(dev)
        with ctx:
            _check_rc(lib.atp_partition_positions(
                desc, len(dests), P, B, tile_offsets.data_ptr(),
                out.data_ptr(), stream), "partition_positions")
        LAUNCHES["partition_positions"] += 1
    return list(out.split(sizes))


# ---- pack_key_lanes ---------------------------------------------------------

MAX_PACK_LANES = 16     # csrc/pack_lanes.cu kMaxLanes
PACK_MISS = 0x7FFFFFFE  # csrc/pack_lanes.cu kMiss: equals no packed build key


def _check_pl(lanes, lo, span, shift, active) -> None:
    L = len(lanes)
    _require(1 <= L <= MAX_PACK_LANES,
             f"1 to {MAX_PACK_LANES} lanes: {L}")
    n = lanes[0].shape[0]
    for x in lanes:
        _require(x.ndim == 1 and x.dtype == torch.int64 and x.shape[0] == n,
                 f"every lane must be ({n},) int64")
    for name, x in (("lo", lo), ("span", span), ("shift", shift)):
        _require(x.shape == (L,) and x.dtype == torch.int64,
                 f"{name} must be ({L},) int64")
    _require(active is None or (active.shape == (n,) and
                                active.dtype == torch.bool),
             f"active must be ({n},) bool")


def pack_key_lanes_plain(lanes, lo, span, shift, active=None):
    """Plain version: some eight elementwise passes per lane."""
    _check_pl(lanes, lo, span, shift, active)
    n = lanes[0].shape[0]
    dev = lanes[0].device
    packed = torch.zeros((n,), dtype=torch.int64, device=dev)
    miss = torch.zeros((n,), dtype=torch.bool, device=dev) if active is None \
        else ~active
    shift = shift.clamp(max=32)
    for j, lane in enumerate(lanes):
        d = (lane - lo[j]) & _U32                  # u32 wraparound
        miss = miss | (d > span[j])
        packed = packed | ((d << shift[j]) & _U32)
    return torch.where(miss, PACK_MISS, packed)


def pack_key_lanes(lanes, lo, span, shift, active=None):
    """Range-pack every row's key lanes into one 32-bit word (the join's
    packed key).

    lanes: L (n,) int64 tensors of u32 values (any stride: the columns of
      a lane matrix will do). lo, span, shift: (L,) int64 tensors on the
      lanes' device: per lane the window start, its width - 1 and the bit
      offset; the wrapper reads none of them on the host. active: (n,)
      bool or None.
    Returns (n,) int64: OR over the lanes of ``((lane - lo) mod 2^32) <<
    shift`` (mod 2^32; a shift of 32 or more leaves nothing) where every
    lane lies in its window (``(lane - lo) mod 2^32 <= span``) and the row
    is active, else ``PACK_MISS``."""
    lanes = list(lanes)
    _check_pl(lanes, lo, span, shift, active)
    tensors = lanes + [lo, span, shift] + ([] if active is None else [active])
    if _on_cpu(tensors):
        return pack_key_lanes_plain(lanes, lo, span, shift, active)
    n = lanes[0].shape[0]
    dev = lanes[0].device
    out = torch.empty((n,), dtype=torch.int64, device=dev)
    if n == 0:
        return out
    for x in (lo, span, shift) + (() if active is None else (active,)):
        _require(x.is_contiguous(), "pack_key_lanes needs contiguous lo, "
                 "span, shift and active")
    L = len(lanes)
    ptrs = (ctypes.c_int64 * L)(*[x.data_ptr() for x in lanes])
    strides = (ctypes.c_int64 * L)(*[x.stride(0) for x in lanes])
    lib = _lib()
    ctx, stream = _device_stream(dev)
    with ctx:
        _check_rc(lib.atp_pack_key_lanes(
            ptrs, strides, L, lo.data_ptr(), span.data_ptr(),
            shift.data_ptr(), None if active is None else active.data_ptr(),
            n, out.data_ptr(), stream), "pack_key_lanes")
    LAUNCHES["pack_key_lanes"] += 1
    return out
