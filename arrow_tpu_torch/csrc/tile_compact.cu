// Tile-local compaction of a selection: level 1 of the take-index filter.
//
// Replaces: arrow_tpu/ops/pallas_kernels.py tile_compact_local
// (_compact_kernel), which ranks the selected rows of a 1024-row tile with
// triangular matmuls and moves their local indices with a 1024 x 1024
// one-hot matmul, because the TPU cannot scatter.
//
// Contract (same as the TPU function, slot for slot): sel (cap,) bool with
// cap % 1024 == 0 -> loc (cap,) int32 and counts (cap / 1024,) int32. For
// tile t, counts[t] is its number of selected rows and
// loc[t * 1024 + r], r < counts[t], is the tile-local index (0..1023) of
// its r-th selected row, in row order; slots past counts[t] hold 0.
//
// What bounds it on an H100: bytes. It reads 1 byte and writes 4 bytes per
// row; the arithmetic is one ballot and two popcounts per row. So one block
// owns one tile with one thread per row: the 1-byte loads and the 4-byte
// stores of a warp are each one contiguous run, every slot of loc is
// written exactly once (ranks below the count by the selected rows, the
// tail by the threads whose own index is past the count), and nothing is
// read twice. The rank of a row is the number of selected rows before it:
// a warp ballot and a popcount of the lower lanes give the rank inside the
// warp, and the first warp scans the 32 warp totals with shuffles to give
// each warp its offset. Blocks share nothing, so they run in any order.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kTile = 1024;          // rows per tile = threads per block
constexpr int kWarps = kTile / 32;   // 32: one lane of warp 0 per warp

__global__ void __launch_bounds__(kTile)
tile_compact_kernel(const uint8_t* __restrict__ sel,
                    int32_t* __restrict__ loc,
                    int32_t* __restrict__ counts) {
  __shared__ int warp_off[kWarps];   // exclusive offset of each warp
  __shared__ int tile_count;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int64_t base = static_cast<int64_t>(blockIdx.x) * kTile;
  const bool flag = sel[base + tid] != 0;
  const unsigned ballot = __ballot_sync(0xffffffffu, flag);
  if (lane == 0) warp_off[warp] = __popc(ballot);
  __syncthreads();
  if (warp == 0) {
    // inclusive scan of the 32 warp totals across the lanes of warp 0
    const int total = warp_off[lane];
    int incl = total;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, incl, d);
      if (lane >= d) incl += up;
    }
    warp_off[lane] = incl - total;
    if (lane == 31) tile_count = incl;
  }
  __syncthreads();
  const int count = tile_count;
  if (flag) {
    const int rank = warp_off[warp] + __popc(ballot & ((1u << lane) - 1u));
    loc[base + rank] = tid;
  }
  if (tid >= count) loc[base + tid] = 0;
  if (tid == 0) counts[blockIdx.x] = count;
}

}  // namespace

extern "C" {

// Rows per tile; the wrapper checks the capacity against it.
int atp_tc_tile_rows() { return kTile; }

int atp_tile_compact_local(const void* sel, int64_t cap, void* loc,
                           void* counts, void* stream) {
  const int64_t tiles = cap / kTile;
  if (tiles == 0) return 0;
  tile_compact_kernel<<<static_cast<unsigned>(tiles), kTile, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(sel), static_cast<int32_t*>(loc),
      static_cast<int32_t*>(counts));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
