// The exchange's two kernels: how many rows go to each destination, and
// where in its destination's bucket each row goes.
//
// Replaces: arrow_tpu/ops/pallas_kernels.py partition_histogram
// (_hist_kernel), which walks the rows in grid steps that run one after
// another, keeps the (1, 128) output block as a running accumulator across
// the steps, and does one full-tile compare + reduce per partition
// (O(n * P) work); and the stable sort by destination, the position passes
// and the per-leaf gather that arrow_tpu/parallel/shuffle.py runs around it
// (a colliding scatter-add would serialise on the TPU; here a row's slot
// comes from counts).
//
// Contract. One call takes S segments (S <= kMaxSeg), each an int32 dest
// vector of its own length at its own address (a shard's destinations), and
// P partitions (P <= kMaxP). Values outside [0, P) are ignored (padding
// rows carry P or -1). The rows of a call are cut into tiles of kTile rows,
// segment after segment (a segment's last tile may be short), T in all.
//   * atp_partition_histogram: counts (S, P) int32, counts[s][p] = #{i :
//     dest_s[i] == p}; and tiles (P, T) int32, tiles[p][t] = the rows of
//     tile t's segment before tile t whose dest is p (the exclusive offsets
//     the second kernel starts from).
//   * atp_partition_positions: for every row, in one int64 buffer with the
//     segments one after another, dest * B + rank where dest is in [0, P)
//     and rank < B, else P * B; rank is the row's stable rank among the rows
//     of its segment with the same dest. That is a row's slot in a (P, B)
//     send buffer, P * B the dump slot.
// Counts and ranks are integers: the results are exact and the same from
// run to run.
//
// What bounds them on an H100: bytes, and at the exchange's real calls
// (2^19 to 2^22 rows a shard, 8 shards on a card) the fixed cost of a
// launch. The first port counted one shard a launch (8 launches a shuffle
// on one card), cleared its output with a memset launch, asked the runtime
// for the device and its SM count on every call and ended with one global
// atomic per bin from each of up to 8 x SMs blocks on the same P words; at
// a 2^19-row shard it read 12 % of its byte bound. This design:
//   * one launch over all S segments: their addresses and lengths travel by
//     value in the kernel's parameters (__grid_constant__), so a shuffle
//     over 8 shards of a card is one histogram launch and one positions
//     launch;
//   * a grid sized to the bytes: one block of kThreads a tile of kTile rows
//     (16 a thread, one 16-byte load per 4 where the segment's address
//     allows), so a small call runs few blocks;
//   * counting with votes, as before: no row touches an atomic, and the
//     few bins of an exchange (P = the mesh size) do not collide. Each warp
//     counts a row of 32 values with one ballot of "value in range" and one
//     ballot per BIT of the value (NB = ceil(log2 P) of them, not one per
//     bin); lane l ANDs them, inverted where bit b of its bin number is 0,
//     and the popcount is the number of values in the row equal to its bin
//     (bins l, l + 32, l + 64, l + 96: J = ceil(2^NB / 32) counters);
//   * no memset and no global atomics per bin: each block writes its tile's
//     P counts; the last block of each segment to finish (an atomic ticket
//     a segment, which it resets to 0 for the next call on the stream)
//     turns its segment's counts into exclusive offsets with one scan of
//     its P runs of tile counts, in place (one warp with shuffles where
//     they are at most 512, the block otherwise), and writes the segment's
//     (P,) totals, so the segments' tails run side by side. Two designs
//     measured slower on an H100 80GB HBM3: one last block scanning all
//     P x T counts (a serial tail of 5 us at 2^22 rows, 75 us at 100M), and
//     a decoupled look-back across the tiles (as csrc/filter_compact.cu
//     does for one count): with P counts a tile, a step of it is an L2
//     round trip, and the tiles of a wave finish together, so the prefixes
//     advance 32 tiles a step (0.31 ms at 100M rows, against 0.16 ms for
//     the counting alone). The tail that is left (ticket, fence, scan) is
//     some 4 us of a 2^22-row call's 13;
//   * the positions kernel reads the tile's offsets and ranks the tile's
//     rows in order: each warp holds 512 consecutive rows (16 coalesced
//     loads a lane), counts them with the same votes, the block turns the
//     warps' counts into each warp's start per bin in shared memory, and
//     the warp walks its rows 32 at a time: the same ballots give each lane
//     the lanes below it with its value (its rank in the step), the start
//     of its bin comes from the lane that owns the bin (a shuffle), and the
//     owners add the step's counts. No sort, no atomics, and the rows'
//     order is kept.
// No call queries the device: the grid is the tile count.

#include <cstdint>
#include <cstring>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 512;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerThread = 16;
constexpr int kTile = kThreads * kRowsPerThread;   // 8192 rows a block
constexpr int kWarpRows = kTile / kWarps;          // 512 rows a warp
constexpr int kMaxP = 128;                         // four bins a lane
constexpr int kMaxSeg = 128;
constexpr int kHistMinBlocks = 4;                  // at most 32 registers
constexpr int kPosMinBlocks = 2;                   // at most 64 registers
constexpr unsigned kFull = 0xffffffffu;

struct Segments {
  const int32_t* ptr[kMaxSeg];
  int64_t row0[kMaxSeg + 1];    // first row of each segment; row0[S] = rows
  int32_t tile0[kMaxSeg + 1];   // first tile of each segment; tile0[S] = T
  int32_t S;
};

// The segment that holds tile t (0 <= t < T): the last s with tile0[s] <= t,
// which is never an empty segment.
__device__ __forceinline__ int segment_of(const Segments& sg, int t) {
  int lo = 0, hi = sg.S;
  while (hi - lo > 1) {
    const int mid = (lo + hi) >> 1;
    if (sg.tile0[mid] <= t) lo = mid; else hi = mid;
  }
  return lo;
}

template <int NB>
struct Bins {
  static constexpr int J = NB <= 5 ? 1 : (1 << (NB - 5));
};

// The step's count of the lane's bins lane + 32 j: the "in range" ballot
// ANDed with each bit ballot, inverted where the bin's bit is 0.
template <int NB>
__device__ __forceinline__ int bin_count(unsigned valid, const unsigned* bits,
                                         int bin) {
  unsigned m = valid;
#pragma unroll
  for (int b = 0; b < NB; ++b) m &= ((bin >> b) & 1) ? bits[b] : ~bits[b];
  return __popc(m);
}

// Votes of one value a lane; every lane of the warp must call it.
template <int NB>
__device__ __forceinline__ unsigned votes(int v, int P, unsigned* bits) {
#pragma unroll
  for (int b = 0; b < NB; ++b) bits[b] = __ballot_sync(kFull, (v >> b) & 1);
  return __ballot_sync(kFull,
                       static_cast<unsigned>(v) < static_cast<unsigned>(P));
}

template <int NB>
__device__ __forceinline__ void count_row(int v, int P, int lane,
                                          int (&cnt)[Bins<NB>::J]) {
  unsigned bits[NB > 0 ? NB : 1];
  const unsigned valid = votes<NB>(v, P, bits);
#pragma unroll
  for (int j = 0; j < Bins<NB>::J; ++j)
    cnt[j] += bin_count<NB>(valid, bits, lane + 32 * j);
}

// The block's tile as 16 values a thread, in any order (counting only):
// 16-byte loads where the tile is whole and its segment 16-byte aligned.
__device__ __forceinline__ void load_any_order(const int32_t* d, int64_t r0,
                                               int64_t n, int tid,
                                               int (&v)[kRowsPerThread]) {
  const bool vec = r0 + kTile <= n &&
                   (reinterpret_cast<uintptr_t>(d) & 15) == 0;
  if (vec) {
    const int4* p = reinterpret_cast<const int4*>(d + r0);
#pragma unroll
    for (int k = 0; k < kRowsPerThread / 4; ++k) {
      const int4 x = __ldg(p + tid + k * kThreads);
      v[4 * k] = x.x; v[4 * k + 1] = x.y; v[4 * k + 2] = x.z;
      v[4 * k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) {
      const int64_t r = r0 + tid + static_cast<int64_t>(k) * kThreads;
      v[k] = r < n ? __ldg(d + r) : -1;
    }
  }
}

constexpr int kScanPer = 8;                       // tile counts a thread
constexpr int kScanRound = kThreads * kScanPer;   // a round of the scan
constexpr int kWarpScanPer = 16;                  // ... by one warp

// Inclusive segmented scan of (head, sum) pairs over the block's threads:
// returns the sum carried INTO this thread (the running sum since the last
// head before it) and in *any_before whether a thread before it had a
// head. s_head / s_sum: kWarps entries of shared memory.
__device__ int block_carry(bool head, int sum, bool* any_before, int* s_head,
                           int* s_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int f = head, s = sum;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int fu = __shfl_up_sync(kFull, f, d);
    const int su = __shfl_up_sync(kFull, s, d);
    if (lane >= d) {
      if (!f) s += su;
      f |= fu;
    }
  }
  if (lane == 31) {
    s_head[warp] = f;
    s_sum[warp] = s;
  }
  __syncthreads();
  if (warp == 0) {
    int wf = lane < kWarps ? s_head[lane] : 0;
    int ws = lane < kWarps ? s_sum[lane] : 0;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int fu = __shfl_up_sync(kFull, wf, d);
      const int su = __shfl_up_sync(kFull, ws, d);
      if (lane >= d) {
        if (!wf) ws += su;
        wf |= fu;
      }
    }
    if (lane < kWarps) {                   // inclusive over warps 0..lane
      s_head[lane] = wf;
      s_sum[lane] = ws;
    }
  }
  __syncthreads();
  const int fb = warp > 0 ? s_head[warp - 1] : 0;
  const int before = warp > 0 ? s_sum[warp - 1] : 0;
  if (!f) s += before;                     // this thread's inclusive sum
  f |= fb;
  const int up = __shfl_up_sync(kFull, s, 1);
  const int fup = __shfl_up_sync(kFull, f, 1);
  *any_before = lane > 0 ? fup : fb;
  return lane > 0 ? up : before;
}

// N consecutive elements, from e0 on (fewer at the end), of a segment's P
// runs of Ts tile counts (element e = p * Ts + l, tile first + l of bin p):
// loaded, summed since the last run head, written back as exclusive
// offsets with the segment's totals where a run ends.
template <int N>
struct ScanRun {
  int x[N];
  int Ts, p0, l0, m;

  __device__ ScanRun(const int32_t* tiles, int T, int first, int Ts_,
                     int total, int e0)
      : Ts(Ts_) {
    m = e0 >= total ? 0 : (total - e0 < N ? total - e0 : N);
    p0 = e0 / Ts;
    l0 = e0 - p0 * Ts;
    int p = p0, l = l0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      x[k] = k < m ? __ldcg(tiles + static_cast<int64_t>(p) * T + first + l)
                   : 0;
      if (++l == Ts) {
        l = 0;
        ++p;
      }
    }
  }

  // The sum since the last run head; *any: a head lies among them.
  __device__ int local(bool* any) const {
    int sum = 0, l = l0;
    *any = false;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k < m) {
        if (l == 0) {
          *any = true;
          sum = 0;
        }
        sum += x[k];
      }
      if (++l == Ts) l = 0;
    }
    return sum;
  }

  // Writes the exclusive offsets from the carried-in ``run``; returns the
  // running sum after the last element.
  __device__ int write(int32_t* tiles, int32_t* counts, int T, int first,
                       int P, int s, int run) const {
    int p = p0, l = l0;
#pragma unroll
    for (int k = 0; k < N; ++k) {
      if (k < m) {
        if (l == 0) run = 0;
        tiles[static_cast<int64_t>(p) * T + first + l] = run;
        run += x[k];
        if (l == Ts - 1) counts[s * P + p] = run;
      }
      if (++l == Ts) {
        l = 0;
        ++p;
      }
    }
    return run;
  }
};

template <int NB>
__global__ void __launch_bounds__(kThreads, kHistMinBlocks)
hist_kernel(const __grid_constant__ Segments sg, int P, int T,
            int32_t* __restrict__ tiles, int32_t* __restrict__ counts,
            unsigned* __restrict__ tickets) {
  constexpr int J = Bins<NB>::J;
  __shared__ int s_hist[kWarps][kMaxP];
  __shared__ int s_head[kWarps], s_sum[kWarps];
  __shared__ int s_carry;
  __shared__ bool s_last;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x;
  const int s = segment_of(sg, t);
  const int first = sg.tile0[s];
  const int Ts = sg.tile0[s + 1] - first;

  {
    const int64_t n = sg.row0[s + 1] - sg.row0[s];
    const int64_t r0 = static_cast<int64_t>(t - first) * kTile;
    int v[kRowsPerThread];
    load_any_order(sg.ptr[s], r0, n, tid, v);
    int cnt[J];
#pragma unroll
    for (int j = 0; j < J; ++j) cnt[j] = 0;
#pragma unroll
    for (int k = 0; k < kRowsPerThread; ++k) count_row<NB>(v[k], P, lane, cnt);
#pragma unroll
    for (int j = 0; j < J; ++j)
      if (lane + 32 * j < P) s_hist[warp][lane + 32 * j] = cnt[j];
  }
  if (t == 0) {                 // block 0 also zeroes the empty segments
    for (int i = tid; i < sg.S * P; i += kThreads) {
      const int q = i / P;
      if (sg.tile0[q] == sg.tile0[q + 1]) counts[i] = 0;
    }
  }
  __syncthreads();
  if (tid < P) {
    int total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) total += s_hist[w][tid];
    tiles[static_cast<int64_t>(tid) * T + t] = total;
    __threadfence();
  }
  __syncthreads();
  if (tid == 0)
    s_last = atomicAdd(tickets + s, 1u) == static_cast<unsigned>(Ts - 1);
  __syncthreads();
  if (!s_last) return;

  // The segment's last block: every tile of the segment has its counts
  // written. Exclusive scan of its P runs of Ts counts in place (element
  // e = p * Ts + the tile's place in the segment): by warp 0 alone, with
  // shuffles, where the segment has at most 32 x kWarpScanPer of them (a
  // path's shuffle of 8 x 2^19 rows has 8 x 64), else by the block,
  // kScanPer consecutive elements a thread, kScanRound a round.
  __threadfence();
  const int total = P * Ts;
  if (total <= 32 * kWarpScanPer) {
    if (warp != 0) return;
    ScanRun<kWarpScanPer> r(tiles, T, first, Ts, total, lane * kWarpScanPer);
    bool any;
    int sum = r.local(&any);
    int f = any;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int fu = __shfl_up_sync(kFull, f, d);
      const int su = __shfl_up_sync(kFull, sum, d);
      if (lane >= d) {
        if (!f) sum += su;
        f |= fu;
      }
    }
    const int up = __shfl_up_sync(kFull, sum, 1);
    r.write(tiles, counts, T, first, P, s, lane > 0 ? up : 0);
    if (lane == 0) tickets[s] = 0u;         // for the next call on the stream
    return;
  }
  if (tid == 0) s_carry = 0;
  for (int base = 0; base < total; base += kScanRound) {
    ScanRun<kScanPer> r(tiles, T, first, Ts, total, base + tid * kScanPer);
    bool any;
    const int sum = r.local(&any);
    __syncthreads();                        // s_carry
    bool any_before;
    int run = block_carry(any, sum, &any_before, s_head, s_sum);
    if (!any_before) run += s_carry;
    run = r.write(tiles, counts, T, first, P, s, run);
    __syncthreads();                        // every thread has read s_carry
    if (tid == kThreads - 1) s_carry = run;   // a next round is whole here
  }
  if (tid == 0) tickets[s] = 0u;            // for the next call on the stream
}

template <int NB>
__global__ void __launch_bounds__(kThreads, kPosMinBlocks)
positions_kernel(const __grid_constant__ Segments sg, int P, int T,
                 int64_t B, const int32_t* __restrict__ tiles,
                 int64_t* __restrict__ out) {
  constexpr int J = Bins<NB>::J;
  __shared__ int s_base[kWarps][kMaxP];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int t = blockIdx.x;
  const int s = segment_of(sg, t);
  const int64_t n = sg.row0[s + 1] - sg.row0[s];
  // the warp's rows: r0 + 32 k + lane, k < 16, in row order
  const int64_t r0 = static_cast<int64_t>(t - sg.tile0[s]) * kTile +
                     warp * kWarpRows;
  const int32_t* d = sg.ptr[s];
  int v[kRowsPerThread];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int64_t r = r0 + 32 * k + lane;
    v[k] = r < n ? __ldg(d + r) : -1;
  }
  int cnt[J];
#pragma unroll
  for (int j = 0; j < J; ++j) cnt[j] = 0;
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) count_row<NB>(v[k], P, lane, cnt);
#pragma unroll
  for (int j = 0; j < J; ++j)
    if (lane + 32 * j < P) s_base[warp][lane + 32 * j] = cnt[j];
  __syncthreads();
  // each warp's start per bin: the tile's offset plus the warps before it
  if (tid < P) {
    int base = tiles[static_cast<int64_t>(tid) * T + t];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int c = s_base[w][tid];
      s_base[w][tid] = base;
      base += c;
    }
  }
  __syncthreads();
#pragma unroll
  for (int j = 0; j < J; ++j)
    cnt[j] = lane + 32 * j < P ? s_base[warp][lane + 32 * j] : 0;

  const unsigned below = (1u << lane) - 1u;
  const int64_t dump = static_cast<int64_t>(P) * B;
  int64_t* o = out + sg.row0[s];
#pragma unroll
  for (int k = 0; k < kRowsPerThread; ++k) {
    const int x = v[k];
    unsigned bits[NB > 0 ? NB : 1];
    const unsigned valid = votes<NB>(x, P, bits);
    unsigned peers = valid;           // the lanes whose value is x
#pragma unroll
    for (int b = 0; b < NB; ++b) peers &= ((x >> b) & 1) ? bits[b] : ~bits[b];
    int start = 0;                    // the step's start of x's bin
#pragma unroll
    for (int j = 0; j < J; ++j) {
      const int sj = __shfl_sync(kFull, cnt[j], x & 31);
      if ((x >> 5) == j) start = sj;
    }
#pragma unroll
    for (int j = 0; j < J; ++j)
      cnt[j] += bin_count<NB>(valid, bits, lane + 32 * j);
    const int64_t r = r0 + 32 * k + lane;
    if (r < n) {
      const int rank = start + __popc(peers & below);
      const bool in = static_cast<unsigned>(x) < static_cast<unsigned>(P) &&
                      rank < B;
      o[r] = in ? static_cast<int64_t>(x) * B + rank : dump;
    }
  }
}

// Host side: the segment descriptor from (address, rows) pairs.
int make_segments(const void* desc, int nseg, Segments* sg, int* T) {
  if (nseg < 1 || nseg > kMaxSeg) return cudaErrorInvalidValue;
  const auto* q = static_cast<const uint8_t*>(desc);
  int64_t rows = 0, tiles = 0;
  for (int s = 0; s < nseg; ++s) {
    int64_t d[2];
    std::memcpy(d, q + 16 * s, sizeof d);
    if (d[1] < 0 || (d[0] & 3) != 0) return cudaErrorInvalidValue;
    sg->ptr[s] = reinterpret_cast<const int32_t*>(d[0]);
    sg->row0[s] = rows;
    sg->tile0[s] = static_cast<int32_t>(tiles);
    rows += d[1];
    tiles += (d[1] + kTile - 1) / kTile;
    if (rows >= (int64_t{1} << 31)) return cudaErrorInvalidValue;
  }
  sg->row0[nseg] = rows;
  sg->tile0[nseg] = static_cast<int32_t>(tiles);
  sg->S = nseg;
  *T = static_cast<int>(tiles);
  return 0;
}

int bits_of(int P) {
  int nb = 0;
  while ((1 << nb) < P) ++nb;
  return nb;
}

template <int NB>
void launch_hist(const Segments& sg, int P, int T, int32_t* tiles,
                 int32_t* counts, unsigned* tickets, cudaStream_t st) {
  hist_kernel<NB><<<T, kThreads, 0, st>>>(sg, P, T, tiles, counts, tickets);
}

template <int NB>
void launch_pos(const Segments& sg, int P, int T, int64_t B,
                const int32_t* tiles, int64_t* out, cudaStream_t st) {
  positions_kernel<NB><<<T, kThreads, 0, st>>>(sg, P, T, B, tiles, out);
}

}  // namespace

extern "C" {

// Largest P and S a call takes, and the rows of a tile; the wrapper raises
// above the first two and sizes the (P, T) tile array with the third.
int atp_ph_max_partitions() { return kMaxP; }
int atp_ph_max_segments() { return kMaxSeg; }
int atp_ph_tile_rows() { return kTile; }

// desc: nseg pairs of int64 (dest address, rows), the rows of all segments
// below 2^31 and at least one tile in all. tiles: (P, T) int32; counts:
// (nseg, P) int32; tickets: kMaxSeg uint32, 0 before the call and 0 after.
int atp_partition_histogram(const void* desc, int nseg, int P, void* tiles,
                            void* counts, void* tickets, void* stream) {
  Segments sg;
  int T = 0;
  int rc = make_segments(desc, nseg, &sg, &T);
  if (rc != 0) return rc;
  if (P < 1 || P > kMaxP || T < 1) return cudaErrorInvalidValue;
  auto* tl = static_cast<int32_t*>(tiles);
  auto* ct = static_cast<int32_t*>(counts);
  auto* tk = static_cast<unsigned*>(tickets);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bits_of(P)) {
    case 0: launch_hist<0>(sg, P, T, tl, ct, tk, st); break;
    case 1: launch_hist<1>(sg, P, T, tl, ct, tk, st); break;
    case 2: launch_hist<2>(sg, P, T, tl, ct, tk, st); break;
    case 3: launch_hist<3>(sg, P, T, tl, ct, tk, st); break;
    case 4: launch_hist<4>(sg, P, T, tl, ct, tk, st); break;
    case 5: launch_hist<5>(sg, P, T, tl, ct, tk, st); break;
    case 6: launch_hist<6>(sg, P, T, tl, ct, tk, st); break;
    default: launch_hist<7>(sg, P, T, tl, ct, tk, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

// desc as above, the same segments as the histogram call whose tiles this
// reads. out: the rows of all segments, int64, segment after segment.
int atp_partition_positions(const void* desc, int nseg, int P, int64_t B,
                            const void* tiles, void* out, void* stream) {
  Segments sg;
  int T = 0;
  int rc = make_segments(desc, nseg, &sg, &T);
  if (rc != 0) return rc;
  if (P < 1 || P > kMaxP || T < 1 || B < 0 || B >= (int64_t{1} << 31))
    return cudaErrorInvalidValue;
  const auto* tl = static_cast<const int32_t*>(tiles);
  auto* o = static_cast<int64_t*>(out);
  const auto st = static_cast<cudaStream_t>(stream);
  switch (bits_of(P)) {
    case 0: launch_pos<0>(sg, P, T, B, tl, o, st); break;
    case 1: launch_pos<1>(sg, P, T, B, tl, o, st); break;
    case 2: launch_pos<2>(sg, P, T, B, tl, o, st); break;
    case 3: launch_pos<3>(sg, P, T, B, tl, o, st); break;
    case 4: launch_pos<4>(sg, P, T, B, tl, o, st); break;
    case 5: launch_pos<5>(sg, P, T, B, tl, o, st); break;
    case 6: launch_pos<6>(sg, P, T, B, tl, o, st); break;
    default: launch_pos<7>(sg, P, T, B, tl, o, st); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
