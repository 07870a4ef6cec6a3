// Partition histogram: how many rows go to each destination of an exchange.
//
// Replaces: arrow_tpu/ops/pallas_kernels.py partition_histogram
// (_hist_kernel), which walks the rows in grid steps that run one after
// another, keeps the (1, 128) output block as a running accumulator across
// the steps, and does one full-tile compare + reduce per partition
// (O(n * P) work).
//
// Contract (same as the TPU function): dest (n,) int32, P partitions ->
// out (P,) int32 with out[p] = #{i : dest[i] == p}. Values outside [0, P)
// are ignored (padding rows carry P or -1). Counts are integers: the result
// is exact and the same from run to run.
//
// What bounds it on an H100: bytes. It reads 4 bytes per row and writes P
// counters, so the only way to be slow is to spend more instruction slots
// per row than the memory system needs to deliver it. Hopper blocks run in any
// order and nothing carries over between them, and with the few bins an
// exchange has (P = the mesh size) a shared-memory histogram would see most
// of a warp's lanes collide on one address, worst of all when the keys are
// skewed. So no row ever touches an atomic. Each warp counts a row of 32
// values with votes: one ballot of "value in range" and one ballot per BIT
// of the value (NB = ceil(log2 P) of them, not one per bin); lane l then
// ANDs the ballots, inverted where bit b of its own bin number is 0, and the
// popcount of that mask is the number of values in the row equal to its
// bin. Lane l owns bins l, l + 32, l + 64, l + 96 (J = ceil(2^NB / 32)
// register counters), so the work per row of 32 values is NB + 1 ballots and
// J popcounts whatever the data holds. Threads load 16 bytes (four values)
// at a time in a grid-stride loop; the at most six values before the first
// and after the last aligned 16 bytes go through one extra row of block 0.
// At the end each warp adds its counters to the block's 128 shared
// counters, and the block adds its non-zero totals to the output with one
// global atomicAdd per bin.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxP = 128;            // four bins per lane
constexpr unsigned kFull = 0xffffffffu;

template <int NB>
struct RowCounter {
  static constexpr int kLowBits = NB < 5 ? NB : 5;
  static constexpr int J = NB <= 5 ? 1 : (1 << (NB - 5));
  unsigned inv[kLowBits > 0 ? kLowBits : 1];  // ~0 where the lane's bit is 0
  int cnt[J];
  int P;

  __device__ explicit RowCounter(int lane, int P_) : P(P_) {
#pragma unroll
    for (int b = 0; b < kLowBits; ++b) inv[b] = ((lane >> b) & 1) ? 0u : kFull;
#pragma unroll
    for (int j = 0; j < J; ++j) cnt[j] = 0;
  }

  // One value per lane; every lane of the warp must call it.
  __device__ __forceinline__ void add(int v) {
    unsigned m = __ballot_sync(kFull, static_cast<unsigned>(v) <
                                          static_cast<unsigned>(P));
#pragma unroll
    for (int b = 0; b < kLowBits; ++b)
      m &= __ballot_sync(kFull, (v >> b) & 1) ^ inv[b];
    if (J == 1) {
      cnt[0] += __popc(m);
    } else {
      const unsigned b5 = __ballot_sync(kFull, (v >> 5) & 1);
      const unsigned b6 = NB == 7 ? __ballot_sync(kFull, (v >> 6) & 1) : 0u;
#pragma unroll
      for (int j = 0; j < J; ++j) {
        unsigned mj = m & ((j & 1) ? b5 : ~b5);
        if (NB == 7) mj &= (j & 2) ? b6 : ~b6;
        cnt[j] += __popc(mj);
      }
    }
  }
};

// dest[0, head) and dest[head + 4 * n4, n) are the scalar edges; vec points
// at dest + head, 16-byte aligned, n4 vectors long.
template <int NB>
__global__ void __launch_bounds__(kThreads)
partition_hist_kernel(const int32_t* __restrict__ dest, int64_t n, int head,
                      int64_t n4, int P, int32_t* __restrict__ out) {
  __shared__ int block_hist[kMaxP];
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  if (tid < kMaxP) block_hist[tid] = 0;
  __syncthreads();

  RowCounter<NB> rc(lane, P);
  const int4* __restrict__ vec = reinterpret_cast<const int4*>(dest + head);
  const int64_t stride = static_cast<int64_t>(gridDim.x) * kThreads;
  // the loop bound is the warp's first index, so that all 32 lanes make the
  // same number of trips and meet in every ballot
  for (int64_t i0 = static_cast<int64_t>(blockIdx.x) * kThreads + (tid - lane);
       i0 < n4; i0 += stride) {
    const int64_t i = i0 + lane;
    int4 v = make_int4(-1, -1, -1, -1);
    if (i < n4) v = __ldg(vec + i);
    rc.add(v.x);
    rc.add(v.y);
    rc.add(v.z);
    rc.add(v.w);
  }
  if (blockIdx.x == 0 && tid < 32) {
    const int64_t tail0 = head + 4 * n4;
    int v = -1;
    if (lane < head) {
      v = dest[lane];
    } else if (tail0 + (lane - head) < n) {
      v = dest[tail0 + (lane - head)];
    }
    rc.add(v);
  }

#pragma unroll
  for (int j = 0; j < RowCounter<NB>::J; ++j) {
    const int bin = lane + 32 * j;
    if (bin < P && rc.cnt[j] != 0) atomicAdd(&block_hist[bin], rc.cnt[j]);
  }
  __syncthreads();
  if (tid < P && block_hist[tid] != 0) atomicAdd(&out[tid], block_hist[tid]);
}

template <int NB>
void launch(const int32_t* dest, int64_t n, int head, int64_t n4, int P,
            int32_t* out, unsigned blocks, cudaStream_t stream) {
  partition_hist_kernel<NB><<<blocks, kThreads, 0, stream>>>(dest, n, head,
                                                             n4, P, out);
}

}  // namespace

extern "C" {

// Largest P the kernel takes; the wrapper raises above it.
int atp_ph_max_partitions() { return kMaxP; }

int atp_partition_histogram(const void* dest_, int64_t n, int P, void* out_,
                            void* stream_) {
  if (P < 1 || P > kMaxP || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int32_t* dest = static_cast<const int32_t*>(dest_);
  int32_t* out = static_cast<int32_t*>(out_);
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  cudaError_t rc = cudaMemsetAsync(out, 0, sizeof(int32_t) * P, stream);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  if (n == 0) return 0;

  // scalars up to the first 16-byte boundary (dest is 4-byte aligned)
  const uintptr_t addr = reinterpret_cast<uintptr_t>(dest);
  int64_t head = ((16 - (addr & 15)) & 15) / 4;
  if (head > n) head = n;
  const int64_t n4 = (n - head) / 4;

  // asked on every call: the current device may differ from call to call
  int device = 0, sms = 0;
  rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int64_t blocks = (n4 + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sms) * 8;   // 2048 threads an SM
  if (blocks > most) blocks = most;
  if (blocks < 1) blocks = 1;
  const unsigned g = static_cast<unsigned>(blocks);

  int nb = 0;
  while ((1 << nb) < P) ++nb;
  switch (nb) {
    case 0: launch<0>(dest, n, static_cast<int>(head), n4, P, out, g, stream); break;
    case 1: launch<1>(dest, n, static_cast<int>(head), n4, P, out, g, stream); break;
    case 2: launch<2>(dest, n, static_cast<int>(head), n4, P, out, g, stream); break;
    case 3: launch<3>(dest, n, static_cast<int>(head), n4, P, out, g, stream); break;
    case 4: launch<4>(dest, n, static_cast<int>(head), n4, P, out, g, stream); break;
    case 5: launch<5>(dest, n, static_cast<int>(head), n4, P, out, g, stream); break;
    case 6: launch<6>(dest, n, static_cast<int>(head), n4, P, out, g, stream); break;
    default: launch<7>(dest, n, static_cast<int>(head), n4, P, out, g, stream); break;
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
