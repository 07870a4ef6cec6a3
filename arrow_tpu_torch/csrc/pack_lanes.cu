// Packed join keys: every row's key lanes range-packed into one 32-bit word.
//
// Replaces: the elementwise passes of arrow_tpu/ops/join.py _pack_lanes (no
// Pallas kernel: XLA fuses them on the TPU; PyTorch runs each as a launch of
// its own, about eight full passes per lane over int64 tensors, which took a
// third of the 100M-row probe of the hash join on the H100).
//
// Contract: L lanes of u32 values held in int64 (lane j's row i at
// lane[j][i * stride[j]]), per lane a window start lo[j], a window width
// span[j] and a bit offset shift[j] (int64 arrays on the device: they come
// from the build's reductions and are never read on the host), an optional
// active flag per row -> out (n,) int64 with
//   out[i] = OR_j (((lane_j[i] - lo_j) mod 2^32) << shift_j) mod 2^32
// where every lane lies in its window ((lane - lo) mod 2^32 <= span) and the
// row is active, else the miss sentinel 0x7FFFFFFE, which no packed build key
// equals. A shift of 32 or more leaves nothing of a lane, as in u32
// arithmetic. Integers only: the result is exact.
//
// What bounds it on an H100: bytes. It reads 8 bytes per lane and row (and
// one for the flag) and writes 8, with a handful of integer operations in
// between, so one row a thread in a grid-stride loop with coalesced 8-byte
// accesses is enough to keep the memory system busy. One body serves every
// lane count: each block copies the lanes' addresses and the 3 * L window
// words into shared memory once and reads them from there (a broadcast). The
// lanes are taken four at a time, each of the four behind a guard and none in
// a loop of unknown length, so that a row's loads are in flight together:
// with the lane count a compile-time constant and everything in registers
// the kernel was no faster at 2 to 6 lanes (PERF.md section 6).

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxLanes = 16;
constexpr int64_t kMiss = 0x7FFFFFFE;

struct Lanes {
  const int64_t* ptr[kMaxLanes];
  int64_t stride[kMaxLanes];
};

__global__ void __launch_bounds__(kThreads)
pack_lanes_kernel(Lanes lanes, int n_lanes, const int64_t* __restrict__ lo,
                  const int64_t* __restrict__ span,
                  const int64_t* __restrict__ shift,
                  const uint8_t* __restrict__ active, int64_t n,
                  int64_t* __restrict__ out) {
  __shared__ const int64_t* ptr_[kMaxLanes];
  __shared__ int64_t stride_[kMaxLanes];
  __shared__ uint32_t lo_[kMaxLanes], span_[kMaxLanes], shift_[kMaxLanes];
  if (threadIdx.x == 0) {
#pragma unroll
    for (int j = 0; j < kMaxLanes; ++j) {
      ptr_[j] = lanes.ptr[j];
      stride_[j] = lanes.stride[j];
    }
  }
  if (threadIdx.x < n_lanes) {
    const int j = threadIdx.x;
    lo_[j] = static_cast<uint32_t>(__ldg(lo + j));
    span_[j] = static_cast<uint32_t>(__ldg(span + j));
    const int64_t s = __ldg(shift + j);
    shift_[j] = s > 32 ? 32u : static_cast<uint32_t>(s);
  }
  __syncthreads();
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * kThreads + threadIdx.x;
       i < n; i += step) {
    bool miss = active != nullptr && active[i] == 0;
    uint32_t packed = 0;
    for (int j0 = 0; j0 < n_lanes; j0 += 4) {
      uint32_t v[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u;
        v[u] = j < n_lanes
                   ? static_cast<uint32_t>(__ldg(ptr_[j] + i * stride_[j]))
                   : 0u;
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const int j = j0 + u;
        if (j < n_lanes) {
          const uint32_t d = v[u] - lo_[j];
          miss |= d > span_[j];
          if (shift_[j] < 32) packed |= d << shift_[j];
        }
      }
    }
    out[i] = miss ? kMiss : static_cast<int64_t>(packed);
  }
}

}  // namespace

extern "C" {

// Most lanes the kernel takes; the wrapper raises above it.
int atp_pl_max_lanes() { return kMaxLanes; }

int atp_pack_key_lanes(const int64_t* lane_ptrs, const int64_t* lane_strides,
                       int n_lanes, const void* lo, const void* span,
                       const void* shift, const void* active, int64_t n,
                       void* out, void* stream_) {
  if (n_lanes < 1 || n_lanes > kMaxLanes || n < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  Lanes lanes;
  for (int j = 0; j < kMaxLanes; ++j) {
    lanes.ptr[j] = j < n_lanes
                       ? reinterpret_cast<const int64_t*>(lane_ptrs[j])
                       : nullptr;
    lanes.stride[j] = j < n_lanes ? lane_strides[j] : 0;
  }
  cudaStream_t stream = static_cast<cudaStream_t>(stream_);
  int device = 0, sms = 0;
  cudaError_t rc = cudaGetDevice(&device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  rc = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  if (rc != cudaSuccess) return static_cast<int>(rc);
  int64_t blocks = (n + kThreads - 1) / kThreads;
  const int64_t most = static_cast<int64_t>(sms) * 8 * 4;
  if (blocks > most) blocks = most;
  pack_lanes_kernel<<<static_cast<unsigned>(blocks), kThreads, 0, stream>>>(
      lanes, n_lanes, static_cast<const int64_t*>(lo),
      static_cast<const int64_t*>(span), static_cast<const int64_t*>(shift),
      static_cast<const uint8_t*>(active), n, static_cast<int64_t*>(out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
