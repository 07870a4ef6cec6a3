// Stream compaction of a batch's columns: the filter kernel.
//
// Replaces: arrow_tpu/ops/pallas_kernels.py filter_compact_chunks
// (_filter_dma_kernel), which compacts each 256-row tile of ONE (cap, C) u8
// matrix with a one-hot MXU matmul and DMAs it to the tile's start, relying
// on the TPU grid running tiles in order. The JAX caller packs every column
// of a batch into that matrix (bitcast to u8 planes side by side) because one
// Pallas kernel moves one matrix, and unpacks the result.
//
// Contract: sel (cap,) bool and up to kMaxCols columns per launch; a column
// is cap rows of `width` bytes each at any row stride (a typed column of 1,
// 2, 4 or 8-byte elements, or the rows of a (cap, C) u8 matrix) -> for each
// column a contiguous output whose first count(sel) rows are the selected
// rows in row order (rows past the count are left unwritten), and count(sel)
// as an int32 on the device. Any cap works, 0 included; counts stay below
// 2^31. Any nonzero byte of sel counts as selected. A one-column call on a
// (cap, C) matrix is the TPU function itself.
//
// What bounds it on an H100: bytes. Per row it reads one selection byte and
// the columns' bytes, and writes the selected rows; the arithmetic is a
// popcount and a shuffle scan per 16 rows. The first port ran two launches
// with a torch cumsum between them, and its caller packed the columns into
// one matrix and unpacked the result with torch passes that cost ten times
// the kernel. This design removes both:
//   * one pass, decoupled look-back (Merrill & Garland, "Single-pass Parallel
//     Prefix Scan with Decoupled Look-back", 2016): a block takes its tile
//     from an atomic ticket (so it only ever waits on tiles already running),
//     counts the tile's selected rows, publishes that aggregate, and looks
//     back over its predecessors' status words, 32 at a time with one warp,
//     until it finds an inclusive prefix; then it publishes its own prefix
//     and writes its rows. A status word holds the call's epoch, the flag and
//     the count in one 64-bit word (written with st.release, read with
//     ld.acquire), so a reader never sees one without the others and a word
//     of an earlier call reads as "not yet". The epoch replaces a reset of
//     the status array: the wrapper keeps one scratch buffer per device and
//     stream and clears it only when it grows or the epoch wraps. One launch
//     a call, nothing between launches;
//   * the columns themselves: their descriptors (in, out, stride, width)
//     travel by value in the kernel's parameters (__grid_constant__), so no
//     matrix is packed or unpacked. For each column consecutive threads write
//     consecutive output units of 8, 4, 2 or 1 bytes (the widest that
//     divides the row width, the stride and both addresses), four loads in
//     flight a thread; the inputs are gathered inside the tile's window from
//     the tile's list of selected rows in shared memory;
//   * the selection is read 16 rows a thread with one 16-byte load (16-byte
//     aligned views; others take sixteen 1-byte loads), ranked with a
//     popcount and a warp shuffle scan, as csrc/tile_compact.cu does;
//   * a batch wider than kMaxCols columns takes further launches: the first
//     also writes each tile's start, the others read it and do not scan;
//   * 512 threads and 8192 rows a block, at least three blocks an SM (40
//     registers a thread): of the block shapes, occupancies and load depths
//     `python -m arrow_tpu_torch.bench_reductions --filter-only` compared,
//     the fastest at the 100M-row call of the filter -> group-by path.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kRowsPerThread = 16;          // one 16-byte selection load
constexpr int kTile = kThreads * kRowsPerThread;   // 8192 rows per block
constexpr int kWarps = kThreads / 32;
constexpr int kMaxCols = 32;
constexpr int kMinBlocks = 3;               // blocks an SM holds at least
constexpr int kUnroll = 4;                  // loads in flight a thread
constexpr int kMaxRowBytes = 1 << 16;      // offsets in a tile fit 32 bits
constexpr unsigned kAggregate = 1;          // status flags
constexpr unsigned kPrefix = 2;

struct Column {
  const uint8_t* in;
  uint8_t* out;
  int64_t stride;     // bytes between input rows, at most kMaxRowBytes
  int32_t width;      // bytes a row, at most kMaxRowBytes
  int32_t unit;       // bytes a copy: 1, 2, 4 or 8
};

struct Columns {
  Column col[kMaxCols];
  int n;
};

// 4 selection bytes (any nonzero = selected) -> 4 mask bits, byte i at bit
// i (as csrc/tile_compact.cu: normalise each byte to 0 / 1, then one
// carry-free multiply gathers the four bits into bits 24..27).
__device__ inline unsigned mask4(unsigned w) {
  w = ((w | ((w & 0x7f7f7f7fu) + 0x7f7f7f7fu)) >> 7) & 0x01010101u;
  return (w * 0x01020408u) >> 24;
}

// status word: epoch (30 bits) | flag (2 bits) | count (32 bits)
__device__ inline unsigned long long status_word(unsigned long long epoch,
                                                 unsigned flag,
                                                 unsigned count) {
  return (epoch << 34) | (static_cast<unsigned long long>(flag) << 32) |
         count;
}

__device__ inline void store_release(unsigned long long* p,
                                     unsigned long long v) {
  asm volatile("st.release.gpu.u64 [%0], %1;" ::"l"(p), "l"(v) : "memory");
}

__device__ inline unsigned long long load_acquire(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.acquire.gpu.u64 %0, [%1];" : "=l"(v) : "l"(p) : "memory");
  return v;
}

// Column `col`'s n selected rows of the tile starting at row r0 (tile-local
// indices in rows[]) to output rows start .. start + n - 1, in units U.
template <typename U>
__device__ inline void copy_rows(const Column& col, const int* rows, int n,
                                 int64_t r0, int64_t start) {
  const int W = col.width / static_cast<int>(sizeof(U));
  // inside the tile every offset fits 32 bits (stride <= kMaxRowBytes)
  const int stride =
      static_cast<int>(col.stride) / static_cast<int>(sizeof(U));
  const U* src = reinterpret_cast<const U*>(col.in) + r0 * stride;
  U* dst = reinterpret_cast<U*>(col.out) + start * W;
  if (W == 1) {                       // a typed column
    for (int j0 = threadIdx.x; j0 < n; j0 += kUnroll * kThreads) {
      U v[kUnroll];
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int j = j0 + k * kThreads;
        if (j < n) v[k] = __ldg(src + rows[j] * stride);
      }
#pragma unroll
      for (int k = 0; k < kUnroll; ++k) {
        const int j = j0 + k * kThreads;
        if (j < n) dst[j] = v[k];
      }
    }
    return;
  }
  const int units = n * W;            // at most kTile * W
  for (int j0 = threadIdx.x; j0 < units; j0 += kUnroll * kThreads) {
    U v[kUnroll];
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = j0 + k * kThreads;
      if (j < units) {
        const int q = j / W;
        v[k] = __ldg(src + (rows[q] * stride + (j - q * W)));
      }
    }
#pragma unroll
    for (int k = 0; k < kUnroll; ++k) {
      const int j = j0 + k * kThreads;
      if (j < units) dst[j] = v[k];
    }
  }
}

// kScan: the first launch of a call (ticket, look-back, count, and the
// tiles' starts when further launches follow); otherwise a further launch
// over more columns that reads the starts (tile = blockIdx.x).
template <bool kScan, bool kAligned>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
filter_columns_kernel(const uint8_t* __restrict__ sel, int64_t cap,
                      int64_t tiles, const __grid_constant__ Columns cols,
                      unsigned long long* __restrict__ scratch,
                      unsigned long long epoch, unsigned long long base,
                      int32_t* __restrict__ starts,
                      int32_t* __restrict__ count_out) {
  __shared__ __align__(16) int s_rows[kTile];
  __shared__ int s_warp[kWarps];
  __shared__ int64_t s_tile, s_start;
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  // scratch[0] is the ticket, scratch[1 + t] tile t's status word
  unsigned long long* ticket = scratch;
  unsigned long long* status = scratch + 1;

  int64_t tile;
  if (kScan) {
    if (tid == 0)
      s_tile = static_cast<int64_t>(atomicAdd(ticket, 1ull) - base);
    __syncthreads();
    tile = s_tile;
  } else {
    tile = blockIdx.x;
  }
  const int64_t r0 = tile * kTile;
  const int local = tid * kRowsPerThread;
  const int64_t row = r0 + local;

  unsigned mask = 0;
  if (row + kRowsPerThread <= cap) {
    if (kAligned) {
      const uint4 v = *reinterpret_cast<const uint4*>(sel + row);
      mask = mask4(v.x) | (mask4(v.y) << 4) | (mask4(v.z) << 8) |
             (mask4(v.w) << 12);
    } else {
#pragma unroll
      for (int i = 0; i < kRowsPerThread; ++i)
        mask |= (sel[row + i] != 0 ? 1u : 0u) << i;
    }
  } else {
    for (int i = 0; i < kRowsPerThread && row + i < cap; ++i)
      mask |= (sel[row + i] != 0 ? 1u : 0u) << i;
  }
  const int count = __popc(mask);
  int incl = count;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, d);
    if (lane >= d) incl += up;
  }
  if (lane == 31) s_warp[warp] = incl;
  __syncthreads();
  int total = 0, rank = incl - count;
#pragma unroll
  for (int w = 0; w < kWarps; ++w) {
    const int c = s_warp[w];
    total += c;
    if (w < warp) rank += c;
  }
  while (mask != 0) {
    s_rows[rank++] = local + __ffs(mask) - 1;
    mask &= mask - 1;
  }

  if (kScan) {
    if (warp == 0) {
      int64_t excl = 0;
      if (tile > 0) {
        if (lane == 0)
          store_release(status + tile, status_word(epoch, kAggregate, total));
        // window of 32 predecessors: lane l reads tile top - l
        for (int64_t top = tile - 1;; top -= 32) {
          const int64_t p = top - lane;
          unsigned flag = 0, c = 0;
          if (p >= 0) {
            unsigned long long w = load_acquire(status + p);
            while ((w >> 34) != epoch) {
              __nanosleep(32);
              w = load_acquire(status + p);
            }
            flag = static_cast<unsigned>(w >> 32) & 3u;
            c = static_cast<unsigned>(w);
          }
          const unsigned prefixes = __ballot_sync(0xffffffffu,
                                                  flag == kPrefix);
          // lanes up to the nearest inclusive prefix contribute
          const int stop = prefixes ? __ffs(prefixes) - 1 : 31;
          int64_t part = lane <= stop ? c : 0;
#pragma unroll
          for (int d = 16; d > 0; d >>= 1)
            part += __shfl_xor_sync(0xffffffffu, part, d);
          excl += part;
          if (prefixes) break;
        }
      }
      if (lane == 0) {
        store_release(status + tile,
                      status_word(epoch, kPrefix,
                                  static_cast<unsigned>(excl + total)));
        s_start = excl;
        if (starts != nullptr) starts[tile] = static_cast<int32_t>(excl);
        if (tile == tiles - 1)
          *count_out = static_cast<int32_t>(excl + total);
      }
    }
  } else if (tid == 0) {
    s_start = starts[tile];
  }
  __syncthreads();

  const int64_t start = s_start;
  for (int c = 0; c < cols.n; ++c) {
    const Column& col = cols.col[c];
    switch (col.unit) {
      // the types __ldg takes
      case 8: copy_rows<unsigned long long>(col, s_rows, total, r0, start);
        break;
      case 4: copy_rows<unsigned>(col, s_rows, total, r0, start); break;
      case 2: copy_rows<unsigned short>(col, s_rows, total, r0, start); break;
      default: copy_rows<unsigned char>(col, s_rows, total, r0, start);
    }
  }
}

template <bool kScan>
void launch(bool aligned, unsigned grid, cudaStream_t s, const uint8_t* sel,
            int64_t cap, int64_t tiles, const Columns& cols,
            unsigned long long* scratch, unsigned long long epoch,
            unsigned long long base, int32_t* starts, int32_t* count) {
  if (aligned)
    filter_columns_kernel<kScan, true><<<grid, kThreads, 0, s>>>(
        sel, cap, tiles, cols, scratch, epoch, base, starts, count);
  else
    filter_columns_kernel<kScan, false><<<grid, kThreads, 0, s>>>(
        sel, cap, tiles, cols, scratch, epoch, base, starts, count);
}

}  // namespace

extern "C" {

// Rows per tile (one block each) and columns per launch; the wrapper sizes
// the scratch and the starts with the first and groups columns by the
// second.
int atp_fc_tile_rows() { return kTile; }
int atp_fc_max_columns() { return kMaxCols; }

// desc: ncols quads of int64 (in address, out address, input row stride in
// bytes, row width in bytes). scratch: 1 + tiles 64-bit words (the ticket,
// then the status words), of which the first reset_bytes are zeroed before
// the launch (0: none; the caller then passes an epoch above every epoch
// the buffer holds and ticket_base = the tickets taken since its last
// reset). starts: (tiles,) int32, needed only when ncols > kMaxCols.
// count: the int32 total. cap >= 1.
int atp_filter_compact(const void* sel, int64_t cap, const void* desc,
                       int ncols, void* count, void* scratch, int64_t epoch,
                       uint64_t ticket_base, int64_t reset_bytes,
                       void* starts, void* stream) {
  if (cap < 1 || ncols < 0 || epoch < 1 || epoch >= (1ll << 30))
    return cudaErrorInvalidValue;
  if (ncols > kMaxCols && starts == nullptr) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const int64_t tiles = (cap + kTile - 1) / kTile;
  auto* words = static_cast<unsigned long long*>(scratch);
  if (reset_bytes > 0) {
    const cudaError_t e = cudaMemsetAsync(scratch, 0, reset_bytes, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const auto* sl = static_cast<const uint8_t*>(sel);
  const bool aligned = reinterpret_cast<uintptr_t>(sel) % 16 == 0;
  const unsigned grid = static_cast<unsigned>(tiles);
  const auto* q = static_cast<const uint8_t*>(desc);
  int c0 = 0;
  do {
    Columns cols;
    cols.n = ncols - c0 < kMaxCols ? ncols - c0 : kMaxCols;
    for (int j = 0; j < cols.n; ++j) {
      int64_t d[4];
      std::memcpy(d, q + 32 * (c0 + j), sizeof d);
      if (d[2] < 0 || d[2] > kMaxRowBytes || d[3] < 0 || d[3] > kMaxRowBytes)
        return cudaErrorInvalidValue;
      Column& col = cols.col[j];
      col.in = reinterpret_cast<const uint8_t*>(d[0]);
      col.out = reinterpret_cast<uint8_t*>(d[1]);
      col.stride = d[2];
      col.width = static_cast<int32_t>(d[3]);
      const uint64_t bits = static_cast<uint64_t>(d[0] | d[1] | d[2] | d[3]);
      col.unit = bits % 8 == 0 ? 8 : bits % 4 == 0 ? 4 : bits % 2 == 0 ? 2 : 1;
    }
    if (c0 == 0)
      launch<true>(aligned, grid, s, sl, cap, tiles, cols, words,
                   static_cast<unsigned long long>(epoch), ticket_base,
                   ncols > kMaxCols ? static_cast<int32_t*>(starts) : nullptr,
                   static_cast<int32_t*>(count));
    else
      launch<false>(aligned, grid, s, sl, cap, tiles, cols, words, 0, 0,
                    static_cast<int32_t*>(starts), nullptr);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return static_cast<int>(e);
    c0 += cols.n;
  } while (c0 < ncols);
  return 0;
}

}  // extern "C"
