// Dense-domain grouped reduction: the group-by kernel for small integer
// key domains.
//
// Replaces: arrow_tpu/ops/pallas_kernels.py dense_group_reduce
// (_dense_group_kernel). On the TPU the grid runs in order and keeps (1, G)
// running accumulators in VMEM; every 1024-row chunk builds a
// (rows x 128-slot) match mask per slot block, so its work is O(n * G).
//
// Contract: gid (n,) i32 is a slot in [0, G), anything else ignored
// (negative = inactive, >= G never matches a slot), or the kernel forms it
// from an int64 key column, its lowest key, its validity and the batch's
// length (which saves the caller three elementwise passes); one reduction
// per kind over its inputs; returns the active row count per slot plus the kind
// outputs, slot for slot, with each kind's identity in empty slots. Kind
// codes match _DG_KINDS in ops/cuda_kernels.py. The nine kinds of the TPU
// function keep its contract (32-bit streams: "sumc" limbs, "imin64" /
// "imax64" (hi, biased lo) pairs). Beside them stand the kinds this card
// can do natively: "sum64" / "min64" / "max64" over one int64 stream and
// "first_row" (the least row index of the slot, no stream), and the bool
// kinds "any8" / "all8": the OR / AND of a bool column's bytes (nonzero =
// true), read as the column lies, one byte a row, into a 32-bit
// accumulator (identity 0 / 1). A kind may carry a validity stream (bool
// bytes); a row whose byte is 0 is skipped for that kind alone.
//
// What of the TPU's shape was dropped: Mosaic has no 64-bit arithmetic, so
// the TPU caller splits an int64 sum into four 16-bit limb streams, an
// int64 min into a pair of 32-bit streams, pre-masks every stream with the
// kind's identity and feeds the first-row kind an iota: twelve 4-byte
// streams where the columns hold 16 bytes a row. Here the kernel reads the
// columns themselves, and two kinds over one column (same pointer) share
// one load.
//
// What bounds it on an H100: the streaming read of gid and the columns
// (bytes), then the shared-memory atomic rate: a row costs one atomic per
// kind plus one for the row count, and only 32-bit integer atomics are
// native in shared memory (a float add and every 64-bit operation compile
// to a compare-and-swap loop). The design:
//   * the work is O(n): each row updates its own slot. Blocks walk the
//     rows in grid-stride steps; each block keeps one accumulator per
//     (slot, kind) in shared memory and folds its non-empty slots into a
//     global workspace once at the end (one global atomic per slot, kind
//     and block, not per row); a last small kernel decodes the workspace
//     into the outputs;
//   * a thread takes 4 consecutive rows a step with 16-byte loads (int4 of
//     gid, float4 / two longlong2 of a column, one 32-bit word of validity
//     bytes). The kinds are fixed per launch: the dispatch on the kind
//     happens once per 4-row step and is uniform across the block, never
//     per row, and a column that the previous kind of the step already
//     loaded is not loaded again. Unaligned views and the last n % 4 rows
//     take scalar loads;
//   * fewer and cheaper atomics: a 64-bit sum is two native 32-bit adds
//     (low word with the old value returned to see the carry, high word
//     only when it is not zero) instead of a CAS loop; every min / max
//     first reads the accumulator and skips the atomic when the row
//     cannot change it (a stale read only costs a redundant atomic), which
//     after a block's first rows is nearly always;
//   * skew: atomics of a warp on one shared-memory word run one after the
//     other. Each step the warp counts the rows that lie in a candidate
//     slot (the slot that was hot in its last step, else the slot of the
//     step's first row: one shuffle, four votes); from `hot_rows` of its
//     128 rows up it reduces those rows with shuffles and makes one
//     atomic per kind for them, the other rows their own. Uniform keys
//     never take that branch; a hot key no longer serialises;
//   * any8 / all8 read 4 rows' bytes as one 32-bit word; only a row that
//     can change the accumulator (a true byte for any, a false one for all)
//     makes an atomic (atomicOr / atomicAnd), and not even that once the
//     accumulator holds the answer, which a block reaches after its first
//     rows. The TPU caller instead widens each bool column to an int32
//     stream pre-masked with the identity and reduces it as imax / imin:
//     two elementwise passes and 4 bytes a row more;
//   * f32 min / max use an order-preserving int32 key. NaN is skipped, as
//     pyarrow skips it: its key loses to every number's and wins only
//     against the identity (INT_MAX for min, INT_MIN for max, which no
//     float maps to), so a slot of NaNs alone gives NaN and an empty one
//     +inf / -inf (the TPU kernel maps NaN to the winning extreme, as
//     jnp.min / jnp.max propagate it);
//   * shared memory is (1 + 4-byte outputs + 2 per 8-byte output) * G * 4
//     bytes; the wrapper splits the kinds over launches so each launch
//     fits. Up to half of an SM's shared memory a block has 512 threads
//     and two blocks share an SM, above it one block of 1024 threads.
// f32 sums with atomics are not bitwise reproducible from run to run.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

enum Kind : int {
  kSum = 0, kMin = 1, kMax = 2, kIMin = 3, kIMax = 4, kCount = 5,
  kSumC = 6, kIMin64 = 7, kIMax64 = 8,
  kSum64 = 9, kMin64 = 10, kMax64 = 11, kFirstRow = 12, kAny8 = 13,
  kAll8 = 14,
};

constexpr int kMaxKinds = 16;
constexpr int kSlotThreads = 256;     // init and finish kernels
constexpr unsigned kFull = 0xffffffffu;

struct DGArgs {
  int nk;
  int kind[kMaxKinds];
  int off[kMaxKinds];              // byte offset of the kind's G accumulators
  const void* in0[kMaxKinds];
  const void* in1[kMaxKinds];      // second input of imin64 / imax64
  const uint8_t* valid[kMaxKinds]; // per-kind validity bytes, or null
  void* out0[kMaxKinds];
  void* out1[kMaxKinds];           // second output of sumc / imin64 / imax64
  // the slot formed from an int64 key column (key null: read from gid)
  const long long* key;
  long long key_lo;
  const long long* key_len_ptr;    // rows in use, on the device; or null:
  long long key_len;               // ... the value
  const uint8_t* key_valid;        // validity bytes of the key, or null
};

__host__ __device__ inline bool wide(int k) {
  return k == kSumC || k == kIMin64 || k == kIMax64 || k == kSum64 ||
         k == kMin64 || k == kMax64;
}

// order-preserving int32 key of a float (as signed ints compare)
__device__ inline int f2key(float x) {
  const int i = __float_as_int(x);
  return i >= 0 ? i : i ^ 0x7fffffff;
}

__device__ inline float key2f(int k) {
  return __int_as_float(k >= 0 ? k : k ^ 0x7fffffff);
}

constexpr int kI32Min = -2147483647 - 1;
constexpr int kI32Max = 2147483647;
constexpr long long kI64Min = -9223372036854775807LL - 1;
constexpr long long kI64Max = 9223372036854775807LL;
constexpr int kKeyNaNMin = 0x7fc00000;         // f2key(+NaN), above +inf
constexpr int kKeyNaNMax = ~kKeyNaNMin;        // f2key(-NaN), below -inf

// identity of the accumulator of kind k, as raw bits
__device__ inline unsigned long long ident_bits(int k) {
  switch (k) {
    case kMin:
    case kIMin:
    case kFirstRow: return static_cast<unsigned>(kI32Max);
    case kAll8: return 1u;
    case kMax:
    case kIMax: return static_cast<unsigned>(kI32Min);
    case kIMin64:
    case kMin64: return static_cast<unsigned long long>(kI64Max);
    case kIMax64:
    case kMax64: return static_cast<unsigned long long>(kI64Min);
    default: return 0;  // sum (0.0f), count, sumc, sum64, any8
  }
}

__device__ inline void fill_identity(char* acc, const DGArgs& a, int G,
                                     int tid, int nthreads) {
  for (int k = 0; k < a.nk; ++k) {
    const int kd = a.kind[k];
    const unsigned long long id = ident_bits(kd);
    if (wide(kd)) {
      auto* p = reinterpret_cast<unsigned long long*>(acc + a.off[k]);
      for (int s = tid; s < G; s += nthreads) p[s] = id;
    } else {
      auto* p = reinterpret_cast<unsigned*>(acc + a.off[k]);
      for (int s = tid; s < G; s += nthreads) p[s] = static_cast<unsigned>(id);
    }
  }
}

// ---- loads of 4 consecutive rows --------------------------------------------
// `vec`: every stream of the launch is aligned for the vector form. Rows
// at or past n read as `fill` (the scalar form guards each row).

__device__ inline void load4(const int* p, int64_t i, int64_t n, bool vec,
                             int fill, int (&x)[4]) {
  if (vec && i + 4 <= n) {
    const int4 v = *reinterpret_cast<const int4*>(p + i);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = i + r < n ? p[i + r] : fill;
  }
}

__device__ inline void load4(const float* p, int64_t i, int64_t n, bool vec,
                             float fill, float (&x)[4]) {
  if (vec && i + 4 <= n) {
    const float4 v = *reinterpret_cast<const float4*>(p + i);
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = i + r < n ? p[i + r] : fill;
  }
}

__device__ inline void load4(const long long* p, int64_t i, int64_t n,
                             bool vec, long long fill, long long (&x)[4]) {
  if (vec && i + 4 <= n) {
    const longlong2 a = *reinterpret_cast<const longlong2*>(p + i);
    const longlong2 b = *reinterpret_cast<const longlong2*>(p + i + 2);
    x[0] = a.x; x[1] = a.y; x[2] = b.x; x[3] = b.y;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = i + r < n ? p[i + r] : fill;
  }
}

__device__ inline void load4_valid(const uint8_t* p, int64_t i, int64_t n,
                                   bool vec, bool (&x)[4]) {
  if (vec && i + 4 <= n) {
    const unsigned w = *reinterpret_cast<const unsigned*>(p + i);
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = ((w >> (8 * r)) & 0xffu) != 0;
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r) x[r] = i + r < n && p[i + r] != 0;
  }
}

// ---- shared-memory atomics ---------------------------------------------------

__device__ inline void s_add_i32(int* p, int v) { atomicAdd(p, v); }

__device__ inline void s_add_f32(float* p, float v) { atomicAdd(p, v); }

// A 64-bit sum held as two arrays of G words (low words, then high
// words): the low add returns the old value, which shows the carry.
__device__ inline void s_add_u64(unsigned* lo_words, int G, int slot,
                                 unsigned long long v) {
  const unsigned lo = static_cast<unsigned>(v);
  unsigned hi = static_cast<unsigned>(v >> 32);
  if (lo != 0) {
    const unsigned old = atomicAdd(lo_words + slot, lo);
    hi += (old + lo < old) ? 1u : 0u;
  }
  if (hi != 0) atomicAdd(lo_words + G + slot, hi);
}

// min / max: skip the atomic when the accumulator already beats the row
__device__ inline void s_min_i32(int* p, int v) {
  if (v < *reinterpret_cast<volatile int*>(p)) atomicMin(p, v);
}
__device__ inline void s_max_i32(int* p, int v) {
  if (v > *reinterpret_cast<volatile int*>(p)) atomicMax(p, v);
}
__device__ inline void s_min_i64(long long* p, long long v) {
  if (v < *reinterpret_cast<volatile long long*>(p)) atomicMin(p, v);
}
__device__ inline void s_max_i64(long long* p, long long v) {
  if (v > *reinterpret_cast<volatile long long*>(p)) atomicMax(p, v);
}
// any / all: only a row that can change the word makes the atomic
__device__ inline void s_or_i32(int* p, int v) {
  if (v != 0 && *reinterpret_cast<volatile int*>(p) == 0) atomicOr(p, 1);
}
__device__ inline void s_and_i32(int* p, int v) {
  if (v == 0 && *reinterpret_cast<volatile int*>(p) != 0) atomicAnd(p, 0);
}

template <typename T, typename Comb>
__device__ inline T warp_all_reduce(T v, Comb comb) {
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) v = comb(v, __shfl_xor_sync(kFull, v, d));
  return v;
}

// One kind over one 4-row step. `hot_mode` (the same for the whole warp):
// many rows of the warp's step lie in slot g0 (`hot` marks them), so the
// warp combines those rows and lane 0 makes one atomic for them; every
// other contributing row makes its own.
template <typename T, typename Comb, typename Atom>
__device__ inline void fold4(bool hot_mode, int lane, int g0,
                             const int (&g)[4], const bool (&ok)[4],
                             const bool (&hot)[4], const T (&x)[4], T ident,
                             Comb comb, Atom atom) {
  if (hot_mode) {
    T v = ident;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (ok[r] && hot[r]) v = comb(v, x[r]);
    v = warp_all_reduce(v, comb);
    if (lane == 0) atom(g0, v);
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (ok[r] && !hot[r]) atom(g[r], x[r]);
  } else {
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (ok[r]) atom(g[r], x[r]);
  }
}

// Marks the rows of this thread that lie in slot g0 and counts them over
// the warp.
__device__ inline int count_hot(const int (&g)[4], int g0, bool (&hot)[4]) {
  int n = 0;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    hot[r] = g[r] == g0;
    n += __popc(__ballot_sync(kFull, hot[r]));
  }
  return n;
}

__device__ inline long long pair_key(int hi, int lo) {
  return static_cast<long long>(
      (static_cast<unsigned long long>(static_cast<unsigned>(hi)) << 32) |
      (static_cast<unsigned>(lo) ^ 0x80000000u));
}

// Fold a block's accumulator of slot `slot` into the global one. Shared
// 64-bit sums are (low words, high words); the global one is a u64.
__device__ inline void merge(char* gbase, const char* sbase, int kd, int G,
                             int slot) {
  switch (kd) {
    case kSum:
      atomicAdd(reinterpret_cast<float*>(gbase) + slot,
                reinterpret_cast<const float*>(sbase)[slot]);
      break;
    case kMin:
    case kIMin:
    case kFirstRow:
      atomicMin(reinterpret_cast<int*>(gbase) + slot,
                reinterpret_cast<const int*>(sbase)[slot]);
      break;
    case kMax:
    case kIMax:
      atomicMax(reinterpret_cast<int*>(gbase) + slot,
                reinterpret_cast<const int*>(sbase)[slot]);
      break;
    case kCount:
      atomicAdd(reinterpret_cast<int*>(gbase) + slot,
                reinterpret_cast<const int*>(sbase)[slot]);
      break;
    case kAny8:
      if (reinterpret_cast<const int*>(sbase)[slot] != 0)
        atomicOr(reinterpret_cast<int*>(gbase) + slot, 1);
      break;
    case kAll8:
      if (reinterpret_cast<const int*>(sbase)[slot] == 0)
        atomicAnd(reinterpret_cast<int*>(gbase) + slot, 0);
      break;
    case kSumC:
    case kSum64: {
      const auto* w = reinterpret_cast<const unsigned*>(sbase);
      atomicAdd(reinterpret_cast<unsigned long long*>(gbase) + slot,
                (static_cast<unsigned long long>(w[G + slot]) << 32) |
                    w[slot]);
      break;
    }
    case kIMin64:
    case kMin64:
      atomicMin(reinterpret_cast<long long*>(gbase) + slot,
                reinterpret_cast<const long long*>(sbase)[slot]);
      break;
    case kIMax64:
    case kMax64:
      atomicMax(reinterpret_cast<long long*>(gbase) + slot,
                reinterpret_cast<const long long*>(sbase)[slot]);
      break;
  }
}

// Workspace layout (shared and global alike): G u32 row counts at byte 0,
// then each kind's G accumulators at a.off[k].
__global__ void dg_init_kernel(char* ws, DGArgs a, int G) {
  const int tid = blockIdx.x * blockDim.x + threadIdx.x;
  const int nthreads = gridDim.x * blockDim.x;
  auto* rows = reinterpret_cast<unsigned*>(ws);
  for (int s = tid; s < G; s += nthreads) rows[s] = 0;
  fill_identity(ws, a, G, tid, nthreads);
}

template <int kThreads, int kMinBlocks>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
dg_reduce_kernel(const int* __restrict__ gid, int64_t n, DGArgs a, int G,
                 int vec_flag, int hot_rows, char* ws) {
  extern __shared__ __align__(16) char smem[];
  auto* s_rows = reinterpret_cast<int*>(smem);
  for (int s = threadIdx.x; s < G; s += kThreads) s_rows[s] = 0;
  fill_identity(smem, a, G, threadIdx.x, kThreads);
  __syncthreads();

  const bool vec = vec_flag != 0;
  const int lane = threadIdx.x & 31;
  constexpr int64_t kStepRows = static_cast<int64_t>(kThreads) * 4;
  const int64_t steps = (n + kStepRows - 1) / kStepRows;
  int64_t key_len = 0;
  if (a.key != nullptr) {
    key_len = a.key_len_ptr != nullptr ? *a.key_len_ptr : a.key_len;
    key_len = key_len < 0 ? 0 : (key_len < n ? key_len : n);
  }
  int last_hot = -1;   // the same in every lane of a warp
  // grid-stride over the steps, so that a run of inactive rows (the rows
  // past a batch's length) is spread over all blocks
  for (int64_t step = blockIdx.x; step < steps; step += gridDim.x) {
    const int64_t i = step * kStepRows + static_cast<int64_t>(threadIdx.x) * 4;
    int g[4];
    if (a.key == nullptr) {
      load4(gid, i, n, vec, -1, g);
    } else if (i >= key_len) {
      g[0] = g[1] = g[2] = g[3] = -1;
    } else {
      long long kx[4];
      bool kv[4] = {true, true, true, true};
      load4(a.key, i, n, vec, 0ll, kx);
      if (a.key_valid != nullptr) load4_valid(a.key_valid, i, n, vec, kv);
#pragma unroll
      for (int r = 0; r < 4; ++r)
        g[r] = i + r >= key_len ? -1
               : kv[r] ? static_cast<int>(
                             static_cast<unsigned long long>(kx[r]) -
                             static_cast<unsigned long long>(a.key_lo))
                       : G - 1;
    }
    bool ok[4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
      ok[r] = static_cast<unsigned>(g[r]) < static_cast<unsigned>(G);
    // skew: is there a slot that many rows of the warp's step share? The
    // candidates are the slot that was hot in the warp's last step, then
    // the slot of the step's first row.
    const int first = __shfl_sync(kFull, g[0], 0);
    int g0 = last_hot >= 0 ? last_hot : first;
    bool hot[4];
    int n_hot = count_hot(g, g0, hot);
    if (n_hot < hot_rows && last_hot >= 0) {
      g0 = first;
      n_hot = count_hot(g, g0, hot);
    }
    const bool hot_mode = n_hot >= hot_rows &&
                          static_cast<unsigned>(g0) < static_cast<unsigned>(G);
    last_hot = hot_mode ? g0 : -1;
    if (!hot_mode && !(ok[0] || ok[1] || ok[2] || ok[3])) continue;
    const int ones[4] = {1, 1, 1, 1};
    fold4(hot_mode, lane, g0, g, ok, hot, ones, 0,
          [](int x, int y) { return x + y; },
          [&](int s, int v) { s_add_i32(s_rows + s, v); });

    // what the step has loaded so far: a kind over the same stream as the
    // kind before it reuses the registers
    const void* have_f = nullptr;
    const void* have_i = nullptr;
    const void* have_l = nullptr;
    const uint8_t* have_v = nullptr;
    float xf[4];
    int xi[4];
    long long xl[4];
    bool valid[4] = {true, true, true, true};
    for (int k = 0; k < a.nk; ++k) {
      const int kd = a.kind[k];
      char* acc = smem + a.off[k];
      const uint8_t* vp = a.valid[k];
      if (vp != have_v) {
        if (vp == nullptr) {
#pragma unroll
          for (int r = 0; r < 4; ++r) valid[r] = true;
        } else {
          load4_valid(vp, i, n, vec, valid);
        }
        have_v = vp;
      }
      const bool okk[4] = {ok[0] && valid[0], ok[1] && valid[1],
                           ok[2] && valid[2], ok[3] && valid[3]};
      switch (kd) {
        case kSum:
        case kMin:
        case kMax: {
          if (a.in0[k] != have_f) {
            load4(static_cast<const float*>(a.in0[k]), i, n, vec, 0.0f, xf);
            have_f = a.in0[k];
          }
          if (kd == kSum) {
            fold4(hot_mode, lane, g0, g, okk, hot, xf, 0.0f,
                  [](float x, float y) { return x + y; },
                  [&](int s, float v) {
                    s_add_f32(reinterpret_cast<float*>(acc) + s, v);
                  });
          } else if (kd == kMin) {
            int key[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              key[r] = isnan(xf[r]) ? kKeyNaNMin : f2key(xf[r]);
            fold4(hot_mode, lane, g0, g, okk, hot, key, kI32Max,
                  [](int x, int y) { return x < y ? x : y; },
                  [&](int s, int v) {
                    s_min_i32(reinterpret_cast<int*>(acc) + s, v);
                  });
          } else {
            int key[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              key[r] = isnan(xf[r]) ? kKeyNaNMax : f2key(xf[r]);
            fold4(hot_mode, lane, g0, g, okk, hot, key, kI32Min,
                  [](int x, int y) { return x > y ? x : y; },
                  [&](int s, int v) {
                    s_max_i32(reinterpret_cast<int*>(acc) + s, v);
                  });
          }
          break;
        }
        case kIMin:
        case kIMax:
        case kCount:
        case kSumC: {
          if (a.in0[k] != have_i) {
            load4(static_cast<const int*>(a.in0[k]), i, n, vec, 0, xi);
            have_i = a.in0[k];
          }
          if (kd == kIMin) {
            fold4(hot_mode, lane, g0, g, okk, hot, xi, kI32Max,
                  [](int x, int y) { return x < y ? x : y; },
                  [&](int s, int v) {
                    s_min_i32(reinterpret_cast<int*>(acc) + s, v);
                  });
          } else if (kd == kIMax) {
            fold4(hot_mode, lane, g0, g, okk, hot, xi, kI32Min,
                  [](int x, int y) { return x > y ? x : y; },
                  [&](int s, int v) {
                    s_max_i32(reinterpret_cast<int*>(acc) + s, v);
                  });
          } else if (kd == kCount) {
            fold4(hot_mode, lane, g0, g, okk, hot, xi, 0,
                  [](int x, int y) { return x + y; },
                  [&](int s, int v) {
                    s_add_i32(reinterpret_cast<int*>(acc) + s, v);
                  });
          } else {
            unsigned long long u[4];
#pragma unroll
            for (int r = 0; r < 4; ++r) u[r] = static_cast<unsigned>(xi[r]);
            fold4(hot_mode, lane, g0, g, okk, hot, u, 0ull,
                  [](unsigned long long x, unsigned long long y) {
                    return x + y;
                  },
                  [&](int s, unsigned long long v) {
                    s_add_u64(reinterpret_cast<unsigned*>(acc), G, s, v);
                  });
          }
          break;
        }
        case kIMin64:
        case kIMax64: {
          int hi[4], lo[4];
          load4(static_cast<const int*>(a.in0[k]), i, n, vec, 0, hi);
          load4(static_cast<const int*>(a.in1[k]), i, n, vec, 0, lo);
          long long key[4];
#pragma unroll
          for (int r = 0; r < 4; ++r) key[r] = pair_key(hi[r], lo[r]);
          if (kd == kIMin64) {
            fold4(hot_mode, lane, g0, g, okk, hot, key, kI64Max,
                  [](long long x, long long y) { return x < y ? x : y; },
                  [&](int s, long long v) {
                    s_min_i64(reinterpret_cast<long long*>(acc) + s, v);
                  });
          } else {
            fold4(hot_mode, lane, g0, g, okk, hot, key, kI64Min,
                  [](long long x, long long y) { return x > y ? x : y; },
                  [&](int s, long long v) {
                    s_max_i64(reinterpret_cast<long long*>(acc) + s, v);
                  });
          }
          break;
        }
        case kSum64:
        case kMin64:
        case kMax64: {
          if (a.in0[k] != have_l) {
            load4(static_cast<const long long*>(a.in0[k]), i, n, vec, 0ll,
                  xl);
            have_l = a.in0[k];
          }
          if (kd == kSum64) {
            unsigned long long u[4];
#pragma unroll
            for (int r = 0; r < 4; ++r)
              u[r] = static_cast<unsigned long long>(xl[r]);
            fold4(hot_mode, lane, g0, g, okk, hot, u, 0ull,
                  [](unsigned long long x, unsigned long long y) {
                    return x + y;
                  },
                  [&](int s, unsigned long long v) {
                    s_add_u64(reinterpret_cast<unsigned*>(acc), G, s, v);
                  });
          } else if (kd == kMin64) {
            fold4(hot_mode, lane, g0, g, okk, hot, xl, kI64Max,
                  [](long long x, long long y) { return x < y ? x : y; },
                  [&](int s, long long v) {
                    s_min_i64(reinterpret_cast<long long*>(acc) + s, v);
                  });
          } else {
            fold4(hot_mode, lane, g0, g, okk, hot, xl, kI64Min,
                  [](long long x, long long y) { return x > y ? x : y; },
                  [&](int s, long long v) {
                    s_max_i64(reinterpret_cast<long long*>(acc) + s, v);
                  });
          }
          break;
        }
        case kAny8:
        case kAll8: {
          // the bool bytes as they lie: 1 where nonzero
          bool b[4];
          load4_valid(static_cast<const uint8_t*>(a.in0[k]), i, n, vec, b);
          const int x[4] = {b[0], b[1], b[2], b[3]};
          if (kd == kAny8) {
            fold4(hot_mode, lane, g0, g, okk, hot, x, 0,
                  [](int p, int q) { return p | q; },
                  [&](int s, int v) {
                    s_or_i32(reinterpret_cast<int*>(acc) + s, v);
                  });
          } else {
            fold4(hot_mode, lane, g0, g, okk, hot, x, 1,
                  [](int p, int q) { return p & q; },
                  [&](int s, int v) {
                    s_and_i32(reinterpret_cast<int*>(acc) + s, v);
                  });
          }
          break;
        }
        case kFirstRow: {
          // n < 2^31 (checked on the host), so the row index fits
          const int row[4] = {static_cast<int>(i), static_cast<int>(i) + 1,
                              static_cast<int>(i) + 2,
                              static_cast<int>(i) + 3};
          fold4(hot_mode, lane, g0, g, okk, hot, row, kI32Max,
                [](int x, int y) { return x < y ? x : y; },
                [&](int s, int v) {
                  s_min_i32(reinterpret_cast<int*>(acc) + s, v);
                });
          break;
        }
      }
    }
  }
  __syncthreads();
  auto* g_rows = reinterpret_cast<unsigned*>(ws);
  for (int s = threadIdx.x; s < G; s += kThreads) {
    const int r = s_rows[s];
    if (r == 0) continue;  // untouched slot: every accumulator is identity
    atomicAdd(g_rows + s, static_cast<unsigned>(r));
    for (int k = 0; k < a.nk; ++k)
      merge(ws + a.off[k], smem + a.off[k], a.kind[k], G, s);
  }
}

__global__ void dg_finish_kernel(const char* __restrict__ ws, DGArgs a,
                                 int G, int* __restrict__ rows_out) {
  const int s = blockIdx.x * blockDim.x + threadIdx.x;
  if (s >= G) return;
  if (rows_out != nullptr)
    rows_out[s] = static_cast<int>(reinterpret_cast<const unsigned*>(ws)[s]);
  for (int k = 0; k < a.nk; ++k) {
    const char* p = ws + a.off[k];
    const int kd = a.kind[k];
    int* o0 = static_cast<int*>(a.out0[k]);
    int* o1 = static_cast<int*>(a.out1[k]);
    if (kd == kMin || kd == kMax) {
      const int key = reinterpret_cast<const int*>(p)[s];
      float v = key2f(key);
      if (key == kI32Max) v = __int_as_float(0x7f800000);        // +inf
      else if (key == kI32Min) v = -__int_as_float(0x7f800000);  // -inf
      else if (key == kKeyNaNMax) v = __int_as_float(0x7fc00000);
      reinterpret_cast<float*>(o0)[s] = v;
    } else if (kd == kSumC) {
      const unsigned long long t =
          reinterpret_cast<const unsigned long long*>(p)[s];
      o0[s] = static_cast<int>(static_cast<unsigned>(t));
      o1[s] = static_cast<int>(static_cast<unsigned>(t >> 32));
    } else if (kd == kIMin64 || kd == kIMax64) {
      const unsigned long long t =
          reinterpret_cast<const unsigned long long*>(p)[s];
      o0[s] = static_cast<int>(static_cast<unsigned>(t >> 32));
      o1[s] = static_cast<int>(static_cast<unsigned>(t) ^ 0x80000000u);
    } else if (kd == kSum64 || kd == kMin64 || kd == kMax64) {
      reinterpret_cast<long long*>(o0)[s] =
          reinterpret_cast<const long long*>(p)[s];
    } else {  // sum (f32 bits), imin, imax, count, first_row, any8, all8
      o0[s] = reinterpret_cast<const int*>(p)[s];
    }
  }
}

template <int kThreads, int kMinBlocks>
int launch_reduce(const int* gid, int64_t n, const DGArgs& a, int G, int vec,
                  int hot_rows, int smem, char* ws, cudaStream_t s) {
  auto* kernel = dg_reduce_kernel<kThreads, kMinBlocks>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int device = 0, sms = 0, per_sm = 0;
  cudaGetDevice(&device);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                      kThreads, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (per_sm < 1) return cudaErrorInvalidConfiguration;
  const int64_t step_rows = static_cast<int64_t>(kThreads) * 4;
  const int64_t steps = (n + step_rows - 1) / step_rows;
  int64_t grid = static_cast<int64_t>(sms) * per_sm;
  if (steps < grid) grid = steps < 1 ? 1 : steps;
  kernel<<<static_cast<unsigned>(grid), kThreads, smem, s>>>(
      gid, n, a, G, vec, hot_rows, ws);
  return static_cast<int>(cudaGetLastError());
}

inline bool aligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to == 0;
}

}  // namespace

extern "C" {

// One launch group: nk <= kMaxKinds kinds whose accumulators fit the
// shared memory of one block. The slots come from gid (n int32), or, with
// gid null, from the int64 column key: row r lies in slot key[r] - key_lo
// (its low 32 bits), in slot G - 1 where key_valid[r] is 0, and in none at
// or past the length (*key_len_ptr on the device, or key_len). in0/in1/valid/out0/out1 are device pointers
// (as 64-bit ints; valid 0 = the kind has no validity stream); rows_out may
// be null (a later group of the same call); hot_rows is the number of rows
// of a warp's 128-row step in one slot from which the warp combines them
// before the atomic (above 128: never); ws is a device workspace of
// ws_bytes = 4 * G * (1 + 4-byte outputs + 2 per 8-byte output) bytes.
int atp_dense_group_reduce(const void* gid, int64_t n, int G, int nk,
                           const int* kinds, const int64_t* in0,
                           const int64_t* in1, const int64_t* valid,
                           const int64_t* out0, const int64_t* out1,
                           void* rows_out, int hot_rows, const void* key,
                           int64_t key_lo, const void* key_len_ptr,
                           int64_t key_len, const void* key_valid, void* ws,
                           int64_t ws_bytes, void* stream) {
  if (nk < 0 || nk > kMaxKinds || G <= 0 || n < 0 || n > kI32Max ||
      (gid == nullptr) == (key == nullptr))
    return cudaErrorInvalidValue;
  DGArgs a{};
  a.nk = nk;
  a.key = static_cast<const long long*>(key);
  a.key_lo = key_lo;
  a.key_len_ptr = static_cast<const long long*>(key_len_ptr);
  a.key_len = key_len;
  a.key_valid = static_cast<const uint8_t*>(key_valid);
  int64_t off = static_cast<int64_t>(G) * 4;
  bool vec = aligned(gid, 16) && aligned(key, 16) && aligned(key_valid, 4);
  for (int k = 0; k < nk; ++k) {
    if (kinds[k] < kSum || kinds[k] > kAll8) return cudaErrorInvalidValue;
    a.kind[k] = kinds[k];
    a.off[k] = static_cast<int>(off);
    a.in0[k] = reinterpret_cast<const void*>(in0[k]);
    a.in1[k] = reinterpret_cast<const void*>(in1[k]);
    a.valid[k] = reinterpret_cast<const uint8_t*>(valid[k]);
    a.out0[k] = reinterpret_cast<void*>(out0[k]);
    a.out1[k] = reinterpret_cast<void*>(out1[k]);
    // a bool stream is read 4 bytes a step
    const bool bytes = kinds[k] == kAny8 || kinds[k] == kAll8;
    vec = vec && aligned(a.in0[k], bytes ? 4 : 16) &&
          aligned(a.in1[k], bytes ? 4 : 16) && aligned(a.valid[k], 4);
    off += static_cast<int64_t>(G) * (wide(kinds[k]) ? 8 : 4);
  }
  if (off != ws_bytes) return cudaErrorInvalidValue;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int smem = static_cast<int>(off);
  const int slot_blocks = (G + kSlotThreads - 1) / kSlotThreads;
  dg_init_kernel<<<slot_blocks, kSlotThreads, 0, s>>>(static_cast<char*>(ws),
                                                     a, G);
  // up to half of an SM's shared memory two blocks of 512 threads share
  // the SM; above it one block of 1024 threads has it alone
  const int* g = static_cast<const int*>(gid);
  char* w = static_cast<char*>(ws);
  const int rc = smem <= 227 * 1024 / 2
                     ? launch_reduce<512, 2>(g, n, a, G, vec, hot_rows, smem,
                                             w, s)
                     : launch_reduce<1024, 1>(g, n, a, G, vec, hot_rows,
                                              smem, w, s);
  if (rc != 0) return rc;
  dg_finish_kernel<<<slot_blocks, kSlotThreads, 0, s>>>(
      static_cast<const char*>(ws), a, G, static_cast<int*>(rows_out));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
