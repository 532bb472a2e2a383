// Batched coupled Newton-Schulz inverse square root for the LETKF solve.
//
// Replaces the TPU kernel cwbnwp_letkf_tpu/ops/pallas_ns.py::_ns_kernel.
// For each k x k matrix a (the whitened normal matrix a_obs):
//
//   A   = a + inflat * I,   c = max_i sum_j |A_ij| / 1.9   (floored at FLT_MIN)
//   W_0 = A / c,            Z_0 = I
//   repeat   r = max |W - I|,   T = (3I - W) / 2,   Z <- T Z,   W <- T (T W)
//   until    r <= tol   or   max_iters steps
//   z   = Z / sqrt(c)
//
// and writes that matrix's step count and last r.  This is the stopping rule
// of the plain PyTorch version (ops/solver.py::ns_invsqrt), applied to each
// matrix on its own: the step after r first drops to tol is still taken, so
// the returned Z is one quadratic step better than r certifies.  The TPU
// kernel stopped a block of matrices on the residual after a step, and the
// plain version stops on the batch maximum; the three differ only below tol.
//
// What bounds it on this card: a step costs 3 k^3 FMAs per matrix, while the
// whole solve moves 8 k^2 bytes of device memory (A in, Z out).  The kernel
// is bound by the FP32 FMA rate and by the shared-memory bandwidth that feeds
// it, never by HBM.  The design keeps everything on chip:
//   - one thread block per matrix; W, Z and two product buffers live in
//     shared memory, padded to kp = k rounded up to 8 with zero rows and
//     columns (4 kp^2 floats: 147 KB at k = 96, so the launch opts in to
//     dynamic shared memory above 48 KB);
//   - T is never stored: T X = 1.5 X - 0.5 W X, and zero padding in W and X
//     stays exactly zero through every product;
//   - each thread accumulates an 8-row strip of one output column, so a row
//     segment of W is one warp-wide broadcast per 8 outputs and X is read
//     row-contiguously across the warp;
//   - plain FP32 FMA on the CUDA cores: no tensor cores, no TF32;
//   - the stopping test is a block-wide max reduction of |W - I|.
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kMaxK = 96;
constexpr int kRows = 8;          // output rows per thread strip; kp is a multiple
constexpr int kMaxThreads = 384;  // 1152 strips at k = 96: three per thread

__host__ __device__ inline int padded(int k) { return (k + kRows - 1) / kRows * kRows; }

// Max that keeps a NaN, so a diverged matrix cannot report convergence.
__device__ inline float max_nan(float a, float b) { return (a > b || isnan(a)) ? a : b; }

// Block-wide max_nan of v.  red holds 33 floats of shared memory.
__device__ float block_max(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  if (warp == 0) {
    v = lane < static_cast<int>(blockDim.x >> 5) ? red[lane] : 0.f;
    for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
    if (lane == 0) red[32] = v;
  }
  __syncthreads();
  const float out = red[32];
  __syncthreads();  // red is reused by the next call
  return out;
}

// out = T x = 1.5 x - 0.5 w x for kp x kp row-major matrices (ld = kp).
__device__ void t_times(const float* __restrict__ w, const float* __restrict__ x,
                        float* __restrict__ out, int kp) {
  const int n_strips = (kp / kRows) * kp;
  for (int s = threadIdx.x; s < n_strips; s += blockDim.x) {
    const int i0 = (s / kp) * kRows;
    const int j = s % kp;
    float acc[kRows];
#pragma unroll
    for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
    for (int l = 0; l < kp; l += 4) {
      const float x0 = x[(l + 0) * kp + j];
      const float x1 = x[(l + 1) * kp + j];
      const float x2 = x[(l + 2) * kp + j];
      const float x3 = x[(l + 3) * kp + j];
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        const float4 wv = *reinterpret_cast<const float4*>(&w[(i0 + r) * kp + l]);
        acc[r] = fmaf(wv.x, x0, acc[r]);
        acc[r] = fmaf(wv.y, x1, acc[r]);
        acc[r] = fmaf(wv.z, x2, acc[r]);
        acc[r] = fmaf(wv.w, x3, acc[r]);
      }
    }
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const int idx = (i0 + r) * kp + j;
      out[idx] = 1.5f * x[idx] - 0.5f * acc[r];
    }
  }
}

__global__ void ns_invsqrt_kernel(const float* __restrict__ a, float* __restrict__ z_out,
                                  int* __restrict__ iters_out, float* __restrict__ resid_out,
                                  int k, float inflat, float tol, int max_iters) {
  extern __shared__ __align__(16) float smem[];
  const int kp = padded(k);
  const int kk = kp * kp;
  float* w = smem;
  float* z = smem + kk;
  float* p = smem + 2 * kk;
  float* q = smem + 3 * kk;
  float* red = smem + 4 * kk;
  const size_t base = static_cast<size_t>(blockIdx.x) * k * k;

  // W = a + inflat I (zero padded), Z = I
  for (int idx = threadIdx.x; idx < kk; idx += blockDim.x) {
    const int i = idx / kp;
    const int j = idx % kp;
    float v = 0.f;
    float e = 0.f;
    if (i < k && j < k) {
      v = a[base + i * k + j];
      if (i == j) {
        v += inflat;
        e = 1.f;
      }
    }
    w[idx] = v;
    z[idx] = e;
  }
  __syncthreads();

  // Gershgorin bound on lam_max, 1.9x looser (same scale as the plain version)
  float rowsum = 0.f;
  for (int i = threadIdx.x; i < k; i += blockDim.x) {
    float s = 0.f;
    for (int j = 0; j < k; ++j) s += fabsf(w[i * kp + j]);
    rowsum = max_nan(rowsum, s);
  }
  const float c = max_nan(block_max(rowsum, red) / 1.9f, FLT_MIN);
  for (int idx = threadIdx.x; idx < kk; idx += blockDim.x) w[idx] = w[idx] / c;
  __syncthreads();

  int it = 0;
  float resid = INFINITY;
  while (resid > tol && it < max_iters) {  // a NaN residual stops too
    float r = 0.f;
    for (int idx = threadIdx.x; idx < kk; idx += blockDim.x) {
      const int i = idx / kp;
      const int j = idx % kp;
      if (i < k && j < k) r = max_nan(r, fabsf(w[idx] - (i == j ? 1.f : 0.f)));
    }
    resid = block_max(r, red);  // uniform across the block, so is the loop
    t_times(w, w, p, kp);       // P = T W
    t_times(w, z, q, kp);       // Q = T Z, the new Z
    __syncthreads();
    t_times(w, p, z, kp);       // T P, the new W, into the old Z's buffer
    __syncthreads();
    float* old_w = w;
    w = z;
    z = q;
    q = old_w;
    ++it;
  }

  const float sc = sqrtf(c);
  for (int idx = threadIdx.x; idx < k * k; idx += blockDim.x) {
    z_out[base + idx] = z[(idx / k) * kp + idx % k] / sc;
  }
  if (threadIdx.x == 0) {
    iters_out[blockIdx.x] = it;
    resid_out[blockIdx.x] = resid;
  }
}

}  // namespace

// a: [batch, k, k] float32, contiguous.  z: same shape.  iters, resid: [batch].
// Launches on `stream` and returns cudaGetLastError() after the launch.
extern "C" int ns_invsqrt_f32(const float* a, float* z, int* iters, float* resid, int batch, int k,
                              float inflat, float tol, int max_iters, void* stream) {
  if (batch <= 0 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const int kp = padded(k);
  const size_t smem = (4 * static_cast<size_t>(kp) * kp + 33) * sizeof(float);
  int threads = ((kp / kRows) * kp + 31) / 32 * 32;
  if (threads > kMaxThreads) threads = kMaxThreads;
  cudaError_t err = cudaFuncSetAttribute(ns_invsqrt_kernel,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  ns_invsqrt_kernel<<<batch, threads, smem, static_cast<cudaStream_t>(stream)>>>(
      a, z, iters, resid, k, inflat, tol, max_iters);
  return static_cast<int>(cudaGetLastError());
}
