// The localization cap's search: per row of the distances, the largest
// threshold that keeps at most n_max records, and the selection under it.
//
// Replaces no TPU kernel: the JAX package's _cap_threshold
// (cwbnwp_letkf_tpu/ops/dense.py:239) is plain XLA.  It was added because
// the same multisection in plain PyTorch (ops/dense.py::_cap_threshold) is
// the port's hottest layer: each of its six rounds writes a [B, 15, R]
// comparison and reduces it to int64 counts, about 35 bytes of device
// memory a (point, record) pair a round and a dozen launches.  This kernel
// is the capped branch of ops/dense.py::terms_from_r2 on a CUDA tensor (the
// record mask, the threshold and the selection) in one launch.
//
// What it computes, bit for bit with that branch (ops/cap_kernel.py::plain):
// for each row b of r2 [B, R], with v_j = r2[b, j] where mask[j], else +inf,
//
//   over = #(v <= cap) > n_max
//   lo = -1,  hi = cap;  six rounds of
//       c_i  = lo + (i / 16) (hi - lo),  i = 1..15
//       n_ok = #{i : #(v <= c_i) <= n_max}
//       lo, hi = [lo, c_1 .. c_15][n_ok],  [c_1 .. c_15, hi][n_ok]
//   thr = over ? lo : cap;   sel[b, j] = v_j <= thr
//
// The three operations of c_i are rounded one by one (__fsub_rn, __fmul_rn,
// __fadd_rn), as PyTorch's three elementwise kernels round them: nvcc would
// contract lo + f * d into one FMA, and that gives other thresholds.
//
// Counting.  With lo <= hi, d = fl(hi - lo) >= 0, so fl(f d) >= 0 and
// c_i >= lo; c_i rises with i; and c_15 <= lo + (15/16)(hi - lo)(1 + 2^-24)^2
// <= hi, so lo <= c_1 <= ... <= c_15 <= hi, and the next bracket keeps
// lo <= hi (it starts so: the wrapper takes 0 <= cap).  A value v <= lo is
// under every candidate, a value above c_15 (or NaN) under none: only
// lo < v <= c_15 is compared with the fifteen candidates.  From the second
// round on the bracket is a sixteenth of the one before, so nearly every
// value costs two compares a round.
//
// What bounds it on this card: a pair's 4 bytes of r2 read and 1 byte of sel
// written, 44 us at 3.35 TB/s for the production slab's [2048, ~14,300].
// The compares come next: the plain algorithm's 92 a pair (the count under
// the cap, 15 a round, the selection) would take 40 us at one a lane and
// clock of 67 TFLOP/s; the bracket test above leaves 15 for a value inside
// a round's bracket (most values under the cap in the first round, few
// after it) and 2 for the others.  The design reads r2 once:
//   - one block of 256 threads a row; thread t owns the 16-byte slots t,
//     t + 256, ... of the row (the row's first element may sit at any
//     4-byte offset in its slot: the slots are aligned to device memory,
//     read as float4, the row's partial first and last slots element by
//     element, +inf outside the row and at masked records).  Where the
//     slots fit in 200 KB (R <= 51,197) they are staged once in dynamic
//     shared memory: 24 KB for the dense vr platform's 6,033 records (four
//     blocks an SM, by the 64 registers a thread), 57 KB for the slab's
//     ~14,300 (three).  Only their owner reads them again, so staging
//     needs no barrier.  Registers would save nothing the compares do not
//     already cost, and would cap a block's slots at compile time.  Above
//     200 KB, each pass reads the row again from device memory (mostly
//     L2): 7 reads of r2 instead of 1;
//   - a round: each thread counts its values into 17 registers (the 15
//     candidates, #(v <= lo), and in the first round #(v <= cap)); each warp
//     sums them with __reduce_add_sync, lane 0 stores the warp's sums, one
//     __syncthreads, then every warp adds up the warps' sums (lane i the
//     count i), takes n_ok by a ballot and forms the next bracket itself.
//     One barrier a round: the warps' sums go to two buffers in turn, and a
//     warp can rewrite one only after the next barrier, which the slowest
//     reader of it has passed;
//   - a row that is not over leaves after the first round with thr = cap;
//   - sel is written a byte at a time, as the owner of a slot, and over by
//     thread 0.
// It launches on the caller's stream, allocates nothing, does not
// synchronise, and cap_search_f32 returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kSplits = 16;  // ops/dense.py::_cap_threshold's defaults
constexpr int kRounds = 6;
constexpr int kCands = kSplits - 1;
constexpr int kCounts = kCands + 2;  // the candidates, #(v <= lo), #(v <= cap)
constexpr int kThreads = 256;
constexpr int kMinBlocks = 4;  // at most 64 registers a thread
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;
// the largest row staged in shared memory, in bytes of its slots
constexpr int kStageCapBytes = 200 * 1024;

static_assert(kCounts <= 32, "a warp's lane per count");

// c_i = lo + (i / 16) (hi - lo), each operation rounded on its own.
__device__ __forceinline__ float candidate(float lo, float hi, int i) {
  return __fadd_rn(lo, __fmul_rn(static_cast<float>(i) * (1.0f / kSplits), __fsub_rn(hi, lo)));
}

// Slot s of the row (elements 4 s - pad .. 4 s - pad + 3), +inf outside
// the row and at masked records.
__device__ __forceinline__ float4 load_slot(const float* __restrict__ row,
                                            const uint8_t* __restrict__ mask, int pad,
                                            int n, int s) {
  const int j0 = 4 * s - pad;
  float v[4];
  if (j0 >= 0 && j0 + 4 <= n) {
    const float4 x = __ldg(reinterpret_cast<const float4*>(row + j0));
    v[0] = x.x, v[1] = x.y, v[2] = x.z, v[3] = x.w;
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      v[q] = j >= 0 && j < n ? __ldg(row + j) : INFINITY;
    }
  }
  if (mask != nullptr) {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      if (j >= 0 && j < n && !__ldg(mask + j)) v[q] = INFINITY;
    }
  }
  return make_float4(v[0], v[1], v[2], v[3]);
}

struct Counts {
  int under[kCands];  // lo < v <= c_i
  int below;          // v <= lo
  int cap;            // v <= cap, the first round only
};

template <bool kFirst>
__device__ __forceinline__ void count_value(float v, float lo, float cap,
                                            const float (&c)[kCands], Counts& n) {
  n.below += v <= lo;
  if (kFirst) n.cap += v <= cap;
  if (v > lo && v <= c[kCands - 1]) {
#pragma unroll
    for (int i = 0; i < kCands; ++i) n.under[i] += v <= c[i];
  }
}

template <bool kStaged>
__device__ __forceinline__ float4 slot_of(const float4* staged, const float* row,
                                          const uint8_t* mask, int pad, int n, int s) {
  return kStaged ? staged[s] : load_slot(row, mask, pad, n, s);
}

// This thread's counts of a round, over its slots.
template <bool kFirst, bool kStaged>
__device__ __forceinline__ Counts count_slots(const float4* staged, const float* row,
                                              const uint8_t* mask, int pad, int n, int slots,
                                              float lo, float cap, const float (&c)[kCands]) {
  Counts cnt = {};
  for (int s = threadIdx.x; s < slots; s += kThreads) {
    const float4 x = slot_of<kStaged>(staged, row, mask, pad, n, s);
    count_value<kFirst>(x.x, lo, cap, c, cnt);
    count_value<kFirst>(x.y, lo, cap, c, cnt);
    count_value<kFirst>(x.z, lo, cap, c, cnt);
    count_value<kFirst>(x.w, lo, cap, c, cnt);
  }
  return cnt;
}

// One block a row of r2 [batch, n]; mask [n] or null; sel [batch, n] and
// over [batch] as bytes 0 / 1.
template <bool kStaged>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
    cap_search_kernel(const float* __restrict__ r2, const uint8_t* __restrict__ mask,
                      uint8_t* __restrict__ sel, uint8_t* __restrict__ over_out, int n,
                      int n_max, float cap) {
  extern __shared__ float4 staged[];
  __shared__ int sums[2][kWarps][kCounts];
  const int b = blockIdx.x;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* row = r2 + static_cast<size_t>(b) * n;
  const int pad = static_cast<int>((reinterpret_cast<uintptr_t>(row) >> 2) & 3);
  const int slots = (pad + n + 3) >> 2;
  if (kStaged) {
    for (int s = threadIdx.x; s < slots; s += kThreads) staged[s] = load_slot(row, mask, pad, n, s);
  }

  float lo = -1.0f, hi = cap;
  bool over = true;
  for (int round = 0; round < kRounds; ++round) {
    float c[kCands];
#pragma unroll
    for (int i = 0; i < kCands; ++i) c[i] = candidate(lo, hi, i + 1);
    Counts cnt = round == 0
                     ? count_slots<true, kStaged>(staged, row, mask, pad, n, slots, lo, cap, c)
                     : count_slots<false, kStaged>(staged, row, mask, pad, n, slots, lo, cap, c);
    int* mine = sums[round & 1][warp];
#pragma unroll
    for (int i = 0; i < kCands; ++i) {
      const int total = __reduce_add_sync(kFull, cnt.under[i]);
      if (lane == 0) mine[i] = total;
    }
    const int below = __reduce_add_sync(kFull, cnt.below);
    const int under_cap = __reduce_add_sync(kFull, cnt.cap);
    if (lane == 0) mine[kCands] = below, mine[kCands + 1] = under_cap;
    __syncthreads();

    int total = 0;
    if (lane < kCounts) {
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += sums[round & 1][w][lane];
    }
    if (round == 0) {
      over = __shfl_sync(kFull, total, kCands + 1) > n_max;
      if (!over) break;  // the same in every warp
    }
    const int below_all = __shfl_sync(kFull, total, kCands);
    const int n_ok = __popc(__ballot_sync(kFull, lane < kCands && below_all + total <= n_max));
    const float next_lo = n_ok == 0 ? lo : candidate(lo, hi, n_ok);
    hi = n_ok == kCands ? hi : candidate(lo, hi, n_ok + 1);
    lo = next_lo;
  }

  const float thr = over ? lo : cap;
  uint8_t* out = sel + static_cast<size_t>(b) * n;
  for (int s = threadIdx.x; s < slots; s += kThreads) {
    const float4 x = slot_of<kStaged>(staged, row, mask, pad, n, s);
    const float v[4] = {x.x, x.y, x.z, x.w};
    const int j0 = 4 * s - pad;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + q;
      if (j >= 0 && j < n) out[j] = v[q] <= thr;
    }
  }
  if (threadIdx.x == 0) over_out[b] = over;
}

struct Plan {
  void (*kernel)(const float*, const uint8_t*, uint8_t*, uint8_t*, int, int, float);
  size_t smem;
  int staged;
};

// The row's slots take at most ceil((n + 3) / 4) float4 (its first element at
// any offset in a slot).
Plan plan_for(int n) {
  const size_t bytes = static_cast<size_t>((n + 3 + 3) / 4) * sizeof(float4);
  if (bytes <= static_cast<size_t>(kStageCapBytes)) return {cap_search_kernel<true>, bytes, 1};
  return {cap_search_kernel<false>, 0, 0};
}

cudaError_t prepare(const Plan& pl) {
  const void* fn = reinterpret_cast<const void*>(pl.kernel);
  cudaError_t err = cudaFuncSetAttribute(fn, cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(pl.smem));
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(fn, cudaFuncAttributePreferredSharedMemoryCarveout,
                              cudaSharedmemCarveoutMaxShared);
}

}  // namespace

// r2: [batch, n] float32, contiguous.  mask: [n] bytes, or null for none.
// sel: [batch, n] bytes, over: [batch] bytes.  Launches on `stream` and
// returns cudaGetLastError() after the launch; a batch of 0 launches nothing.
extern "C" int cap_search_f32(const float* r2, const uint8_t* mask, uint8_t* sel, uint8_t* over,
                              int batch, int n, int n_max, float cap, void* stream) {
  if (batch < 0 || n < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const Plan pl = plan_for(n);
  const cudaError_t err = prepare(pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.kernel<<<batch, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(r2, mask, sel, over,
                                                                             n, n_max, cap);
  return static_cast<int>(cudaGetLastError());
}

// What a launch over rows of n records uses: out[0..4] = threads per block,
// dynamic shared memory in bytes, registers per thread, resident blocks per
// SM, and 1 where the row is staged in shared memory (0: read each pass).
// Launches nothing.  Returns a CUDA error code.
extern "C" int cap_search_config(int n, int* out) {
  if (n < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_for(n);
  cudaError_t err = prepare(pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fn = reinterpret_cast<const void*>(pl.kernel);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, kThreads, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = kThreads;
  out[1] = static_cast<int>(pl.smem);
  out[2] = attr.numRegs;
  out[3] = blocks;
  out[4] = pl.staged;
  return 0;
}
