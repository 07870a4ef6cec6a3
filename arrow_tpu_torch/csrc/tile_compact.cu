// The take-index filter: tile-local compaction of a selection (level 1)
// and the stitch of the tiles into global take indices (level 2).
//
// Replaces: arrow_tpu/ops/pallas_kernels.py tile_compact_local
// (_compact_kernel), which ranks the selected rows of a 1024-row tile with
// triangular matmuls and moves their local indices with a 1024 x 1024
// one-hot matmul, because the TPU cannot scatter; and level 2 of
// arrow_tpu/ops/selection.py _pallas_take_indices, which sends every
// output position back to its source tile (a scatter, a scan and two
// capacity-sized gathers) for the same reason.
//
// Contract of level 1 (same as the TPU function, slot for slot): sel (cap,)
// bool with cap % 1024 == 0 -> loc (cap,) int32 and counts (cap / 1024,)
// int32. For tile t, counts[t] is its number of selected rows and
// loc[t * 1024 + r], r < counts[t], is the tile-local index (0..1023) of
// its r-th selected row, in row order; slots past counts[t] hold 0. Any
// nonzero byte of sel counts as selected.
//
// Contract of level 2 (tile_stitch): with starts the exclusive prefix sum
// of counts (T + 1 entries, starts[T] the total),
// indices[starts[t] + r] = t * 1024 + loc[t * 1024 + r] for r < counts[t],
// and indices[j] = 0 for starts[T] <= j < out_cap.
//
// What bounds both on an H100: bytes. Level 1 reads 1 byte and writes
// 4 bytes a row and does a handful of integer operations; level 2 reads
// the live slots of loc and writes 4 bytes per output position. The card
// only reaches its memory rate with wide accesses and many of them in
// flight, so the TPU's shape (and the first port's one thread per row with
// its 1-byte loads) is dropped:
//   * level 1: a thread owns 16 consecutive rows and reads them with ONE
//     16-byte load; the bytes are normalised to 0 / 1 and folded into a
//     16-bit mask whose popcount is the thread's count. A warp covers 512
//     rows, a tile is two warps: the rank of a row is the exclusive
//     shuffle scan of the counts across the warp, plus the other warp's
//     total through one shared-memory word, plus the popcount of the
//     thread's own lower mask bits. The tile's loc row is assembled in
//     shared memory (4 KB) and goes out with 16-byte stores, every slot
//     exactly once (slots past the count as zeros), 512 contiguous bytes
//     a warp. A block holds four tiles, so it has 256 independent 16-byte
//     loads in flight and the grid is a quarter of the tile count.
//     A sel whose address is not 16-byte aligned (a sliced view) takes the
//     same kernel with sixteen 1-byte loads a thread.
//   * level 2: the card can scatter, so once the starts are known a tile's
//     indices go straight to their place: 64 threads a tile read only the
//     live slots of its loc row (coalesced 4-byte loads) and write one
//     contiguous run, four loads in flight a thread; the zero tail is a
//     grid-stride loop of 16-byte stores in the same launch. Every output
//     slot is written exactly once, nothing is read on the host.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;                 // rows per tile
constexpr int kRowsPerThread = 16;          // one 16-byte load
constexpr int kTileThreads = kTile / kRowsPerThread;      // 64 = two warps
constexpr int kTilesPerBlock = 4;
constexpr int kThreads = kTileThreads * kTilesPerBlock;   // 256
constexpr int kWarps = kThreads / 32;

// 4 selection bytes (any nonzero = selected) -> 4 mask bits, byte i at
// bit i. First every byte becomes 0 or 1 (bit 7 of (b & 0x7f) + 0x7f is
// set iff the low 7 bits are not all zero; or-ing b adds its own bit 7),
// then one multiply gathers the four bits: the 16 partial products land on
// 16 distinct bit positions, so nothing carries, and bits 24..27 hold
// bytes 0..3.
__device__ inline unsigned mask4(unsigned w) {
  w = ((w | ((w & 0x7f7f7f7fu) + 0x7f7f7f7fu)) >> 7) & 0x01010101u;
  return (w * 0x01020408u) >> 24;
}

template <bool kAligned>
__global__ void __launch_bounds__(kThreads)
tile_compact_kernel(const uint8_t* __restrict__ sel, int64_t tiles,
                    int32_t* __restrict__ loc, int32_t* __restrict__ counts) {
  __shared__ __align__(16) int s_loc[kTilesPerBlock][kTile];
  __shared__ int warp_total[kWarps];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tile_in_block = tid / kTileThreads;
  const int tt = tid % kTileThreads;          // thread within its tile
  const int64_t tile =
      static_cast<int64_t>(blockIdx.x) * kTilesPerBlock + tile_in_block;
  const bool live = tile < tiles;

  unsigned mask = 0;
  if (live) {
    const uint8_t* p = sel + tile * kTile + tt * kRowsPerThread;
    if (kAligned) {
      const uint4 v = *reinterpret_cast<const uint4*>(p);
      mask = mask4(v.x) | (mask4(v.y) << 4) | (mask4(v.z) << 8) |
             (mask4(v.w) << 12);
    } else {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        mask |= (p[i] != 0 ? 1u : 0u) << i;
    }
  }
  const int count = __popc(mask);
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  const int first_total = warp_total[warp & ~1];
  const int tile_count = first_total + warp_total[warp | 1];
  int rank = incl - count + ((warp & 1) ? first_total : 0);
  int* row = s_loc[tile_in_block];
  const int base = tt * kRowsPerThread;
  while (mask != 0) {
    row[rank++] = base + __ffs(mask) - 1;
    mask &= mask - 1;
  }
  __syncthreads();
  if (!live) return;
  int4* out = reinterpret_cast<int4*>(loc + tile * kTile);
  const int4* rows4 = reinterpret_cast<const int4*>(row);
#pragma unroll
  for (int i = 0; i < kTile / 4 / kTileThreads; ++i) {
    const int q = i * kTileThreads + tt;      // which group of 4 slots
    int4 v = rows4[q];
    const int slot = q * 4;
    if (slot + 0 >= tile_count) v.x = 0;
    if (slot + 1 >= tile_count) v.y = 0;
    if (slot + 2 >= tile_count) v.z = 0;
    if (slot + 3 >= tile_count) v.w = 0;
    out[q] = v;
  }
  if (tt == 0) counts[tile] = tile_count;
}

__global__ void __launch_bounds__(kThreads)
tile_stitch_kernel(const int32_t* __restrict__ loc,
                   const int32_t* __restrict__ counts,
                   const int32_t* __restrict__ starts, int64_t tiles,
                   int64_t out_cap, int32_t* __restrict__ indices) {
  const int tid = threadIdx.x;
  const int tt = tid % kTileThreads;
  const int64_t tile = static_cast<int64_t>(blockIdx.x) * kTilesPerBlock +
                       tid / kTileThreads;
  if (tile < tiles) {
    const int count = counts[tile];
    const int64_t start = starts[tile];
    const int32_t* row = loc + tile * kTile;
    const int32_t base = static_cast<int32_t>(tile * kTile);
    // four loads in flight a thread before the first store
    for (int r0 = tt; r0 < count; r0 += 4 * kTileThreads) {
      int32_t v[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + j * kTileThreads;
        v[j] = r < count ? row[r] : 0;
      }
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int r = r0 + j * kTileThreads;
        const int64_t dst = start + r;
        if (r < count && dst < out_cap) indices[dst] = base + v[j];
      }
    }
  }
  // the zero tail, shared by the whole grid: single slots up to the first
  // 16-byte boundary and after the last, 16-byte stores between
  const int64_t total = starts[tiles];
  const int64_t gtid = static_cast<int64_t>(blockIdx.x) * kThreads + tid;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  int64_t head_end = (total + 3) & ~static_cast<int64_t>(3);
  if (head_end > out_cap) head_end = out_cap;
  const int64_t body_end =
      head_end + ((out_cap - head_end) & ~static_cast<int64_t>(3));
  if (gtid < head_end - total) indices[total + gtid] = 0;
  if (gtid < out_cap - body_end) indices[body_end + gtid] = 0;
  int4* body = reinterpret_cast<int4*>(indices + head_end);
  const int64_t quads = (body_end - head_end) / 4;
  for (int64_t q = gtid; q < quads; q += stride)
    body[q] = make_int4(0, 0, 0, 0);
}

inline unsigned blocks_for(int64_t tiles) {
  return static_cast<unsigned>((tiles + kTilesPerBlock - 1) / kTilesPerBlock);
}

}  // namespace

extern "C" {

// Rows per tile; the wrapper checks the capacity against it.
int atp_tc_tile_rows() { return kTile; }

int atp_tile_compact_local(const void* sel, int64_t cap, void* loc,
                           void* counts, void* stream) {
  const int64_t tiles = cap / kTile;
  if (tiles == 0) return 0;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const uint8_t*>(sel);
  auto* l = static_cast<int32_t*>(loc);
  auto* c = static_cast<int32_t*>(counts);
  if (reinterpret_cast<uintptr_t>(sel) % 16 == 0)
    tile_compact_kernel<true><<<blocks_for(tiles), kThreads, 0, s>>>(
        p, tiles, l, c);
  else
    tile_compact_kernel<false><<<blocks_for(tiles), kThreads, 0, s>>>(
        p, tiles, l, c);
  return static_cast<int>(cudaGetLastError());
}

// loc (tiles * 1024,), counts (tiles,), starts (tiles + 1,) -> indices
// (out_cap,); tiles >= 1.
int atp_tile_stitch(const void* loc, const void* counts, const void* starts,
                    int64_t tiles, int64_t out_cap, void* indices,
                    void* stream) {
  if (tiles < 1 || out_cap < 0) return cudaErrorInvalidValue;
  if (out_cap == 0) return 0;
  tile_stitch_kernel<<<blocks_for(tiles), kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(loc), static_cast<const int32_t*>(counts),
      static_cast<const int32_t*>(starts), tiles, out_cap,
      static_cast<int32_t*>(indices));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
