// Batched coupled Newton-Schulz inverse square root for the LETKF solve.
//
// Replaces the TPU kernels cwbnwp_letkf_tpu/ops/pallas_ns.py::_ns_kernel
// (K1, "trio") and ::_ns_kernel_rmul (K2, "rmul"), as two compile-time
// variants of one kernel.  For each k x k matrix a (the whitened normal
// matrix a_obs):
//
//   A   = a + inflat * I,   c = max_i sum_j |A_ij| / 1.9   (floored at FLT_MIN)
//   W_0 = A / c,            Z_0 = I
//   repeat   r = max |W - I|,   T = (3I - W) / 2,
//            trio:  Z <- T Z,   W <- T (T W)
//            rmul:  U = W T,    Z <- Z T,   W <- U T
//   until    r <= tol   or   max_iters steps
//   z   = Z / sqrt(c)
//
// Every iterate is a polynomial in A, so W, Z and T commute and the two
// variants agree in exact arithmetic; they differ in which operand each
// product takes from the left, hence in float32 rounding.  On the TPU rmul
// let one block-diagonal T serve as the shared matrix-unit weight; here both
// are the same three shared-memory products.
//
// The kernel writes each matrix's step count and last r.  This is the
// stopping rule of the plain PyTorch versions (ops/solver.py::ns_invsqrt and
// ::ns_invsqrt_rmul), applied to each matrix on its own: the step after r
// first drops to tol is still taken, so the returned Z is one quadratic step
// better than r certifies.  The TPU kernels stopped a block of matrices on
// the residual after a step, and the plain versions stop on the batch
// maximum; the three rules differ only below tol.
//
// What bounds it on this card: a step costs 3 k^3 FMAs per matrix, while the
// whole solve moves 8 k^2 bytes of device memory (A in, Z out).  The bound is
// the FP32 FMA rate of the CUDA cores (67 TFLOP/s on an H100 SXM: 0.35 ms for
// [12288, 40, 40], 0.81 ms for [2048, 96, 96] and 1.92 ms for
// [2048, 128, 128] at 5 steps), never HBM.  A
// scheduler starts one instruction a clock, so the FMA rate is reached only
// by a stream that is all FMAs, from at least two warps per scheduler (one
// warp starts an FMA every other clock).  The design spends as few other
// instructions, shared-memory loads first, and as few barriers per FMA as it
// can, and keeps the warp count a multiple of the four schedulers:
//   - one thread block per matrix; W, Z and one product buffer P live in
//     shared memory, zero padded to whole tiles (3 x 96 x 96 floats = 111 KB
//     at k = 96, 3 x 128 x 128 floats = 192 KB at k = 128, the largest k
//     whose three buffers fit the 227 KB a block may opt in to; the launch
//     opts in to dynamic shared memory above 48 KB);
//   - T is never stored: T X = 1.5 X - 0.5 W X and X T = 1.5 X - 0.5 X W,
//     and zero padding in W and X stays exactly zero through every product;
//   - each thread owns a TM x 4 register tile of the output: per four values
//     of the inner index it loads TM float4 of the left operand and 4 float4
//     of the right one for 16 TM FMAs.  TM = 8 up to k = 80 (two warps at
//     k = 40), TM = 6 from 81 to 96: k = 96 is then 16 x 24 tiles on 12
//     whole warps, three per scheduler, where 8-row tiles fill 9 warps and
//     leave one scheduler with a third more work than the others.  From 97
//     to 128, TM = 8 again: k = 128 is 16 x 32 tiles on 16 warps, four per
//     scheduler, and 6-row tiles would take 22 warps at 93 registers a
//     thread, fewer than the two tiles of stage 2 need;
//   - a step is two stages.  Stage 1 writes P = T W (= W T).  Stage 2 forms
//     the new Z and the new W together, since they share an operand (W on
//     the left for trio, W on the right for rmul): that operand is loaded
//     once for both.  The two tiles stay in registers until a barrier, then
//     overwrite Z and W in place, so there is no fourth buffer;
//   - lanes run along a row strip first, so the lanes of a warp read one or
//     two row segments of the left operand (a broadcast) and neighbouring
//     float4 of one row of the right operand; a thread's rows are
//     interleaved (ti, ti + nti, ...), so those row segments are adjacent
//     rows;
//   - the stopping test costs no pass and no barrier of its own: the thread
//     that holds a tile of the new W takes max|W' - I| from its registers,
//     and the per-warp maxima cross the block at the barriers the stage
//     needs anyway.  The first residual is taken once, while W_0 is scaled;
//   - the passes over the whole matrix (load, scale by 1/c, write out) keep a
//     thread's float4 chunks in registers, all in flight at once, walk their
//     indices without a division, and divide without a branch (div_by): a
//     matrix spends about a tenth of its time outside the steps at 5 steps;
//   - at k = 40 and k = 96, the ensemble sizes of the bench case and of the
//     production namelist, the tile counts are template constants: shared
//     memory offsets become immediates and the loop is 128 FMAs, 12 loads and
//     6 other instructions; any other k, k = 97-128 included, reads them at
//     run time, which costs a multiplication per address (examples/
//     layout_ab.py times k = 128 as a constant against it);
//   - plain FP32 FMA on the CUDA cores, each output element summed over the
//     inner index in order: no tensor cores, no TF32.
// Registers (up to 165 a thread, no spills) hold 6 blocks of 64 threads on an
// SM at k = 40 and one block of 384 threads at k = 96; at k = 128 shared
// memory holds one block of 512 threads, whose launch bound caps a thread at
// 128 registers, and ptxas spills 64-92 bytes a thread (97 <= k <= 128:
// the two register tiles of stage 2 and the addresses do not all fit).
// ns_invsqrt_config reports them for a given k.
#include <cuda_runtime.h>

#include <cfloat>
#include <cmath>

namespace {

constexpr int kMaxK = 128;
constexpr int kWideK = 80;    // 8-row tiles up to here, 6-row tiles to kMidK
constexpr int kMidK = 96;     // 8-row tiles again above here
// tiles (output floats / 4) at k = 96 and 128: a launch bound of
// kTiles96 / TM threads up to k = 96 (288 and 384), kTiles128 / 8 = 512 above
constexpr int kTiles96 = (kMidK / 4) * kMidK;
constexpr int kTiles128 = (kMaxK / 4) * kMaxK;
constexpr int kRedFloats = 16;  // per-warp maxima: at most 16 warps

// Max that keeps a NaN, so a diverged matrix cannot report convergence.
__device__ __forceinline__ float max_nan(float a, float b) {
#ifdef __CUDA_ARCH__
  float out;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(out) : "f"(a), "f"(b));
  return out;
#else
  return (a > b || isnan(a)) ? a : b;
#endif
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v = max_nan(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The block-wide max_nan of what each warp put into red, the same value in
// every thread.
__device__ __forceinline__ float red_max(const float* red) {
  float out = red[0];
  const int n_warps = blockDim.x >> 5;
  for (int wi = 1; wi < n_warps; ++wi) out = max_nan(out, red[wi]);
  return out;
}

// Block-wide max_nan of v.  Also publishes earlier shared-memory writes.
__device__ float block_max(float v, float* red) {
  v = warp_max(v);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  const float out = red_max(red);
  __syncthreads();  // red is reused by the next call
  return out;
}

// x / d with r = 1 / d (rounded): the quotient x r, corrected once by its
// exact remainder, which rounds as the division does (Markstein).  The
// division operator itself carries a branch to a slow path for special
// operands, and a run of divisions then executes one after the other; this
// form has no branch, so the passes that scale a whole matrix pipeline.  A NaN
// in x or d still gives a NaN.
__device__ __forceinline__ float div_by(float x, float d, float r) {
  const float q = x * r;
  return fmaf(fmaf(-q, d, x), r, q);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// acc[c] += sum over the four inner indices m of l[m] * r[m][c], m in order
__device__ __forceinline__ void fma4(float (&acc)[4], const float4& lv, const float4 (&rv)[4]) {
  acc[0] = fmaf(lv.x, rv[0].x, acc[0]);
  acc[1] = fmaf(lv.x, rv[0].y, acc[1]);
  acc[2] = fmaf(lv.x, rv[0].z, acc[2]);
  acc[3] = fmaf(lv.x, rv[0].w, acc[3]);
  acc[0] = fmaf(lv.y, rv[1].x, acc[0]);
  acc[1] = fmaf(lv.y, rv[1].y, acc[1]);
  acc[2] = fmaf(lv.y, rv[1].z, acc[2]);
  acc[3] = fmaf(lv.y, rv[1].w, acc[3]);
  acc[0] = fmaf(lv.z, rv[2].x, acc[0]);
  acc[1] = fmaf(lv.z, rv[2].y, acc[1]);
  acc[2] = fmaf(lv.z, rv[2].z, acc[2]);
  acc[3] = fmaf(lv.z, rv[2].w, acc[3]);
  acc[0] = fmaf(lv.w, rv[3].x, acc[0]);
  acc[1] = fmaf(lv.w, rv[3].y, acc[1]);
  acc[2] = fmaf(lv.w, rv[3].z, acc[2]);
  acc[3] = fmaf(lv.w, rv[3].w, acc[3]);
}

// A thread's TM x 4 tile of l r.  l points at the tile's first row of the
// left operand (its rows are rs floats apart), r at the tile's first column
// of the right operand; ld is the leading dimension and the number of inner
// indices.
template <int TM>
__device__ __forceinline__ void product(float (&acc)[TM][4], const float* l, const float* r,
                                        int rs, int ld) {
#pragma unroll
  for (int row = 0; row < TM; ++row) {
#pragma unroll
    for (int c = 0; c < 4; ++c) acc[row][c] = 0.f;
  }
  for (int m = 0; m < ld; m += 4) {
    float4 rv[4];
#pragma unroll
    for (int q = 0; q < 4; ++q) rv[q] = ld4(r + (m + q) * ld);
#pragma unroll
    for (int row = 0; row < TM; ++row) fma4(acc[row], ld4(l + row * rs + m), rv);
  }
}

// Two tiles at once that share an operand: acc1 = l1 r1 and acc2 = l1 r2
// (kShareL), or acc1 = l1 r1 and acc2 = l2 r1.  The shared operand is loaded
// once.
template <int TM, bool kShareL>
__device__ __forceinline__ void product2(float (&acc1)[TM][4], float (&acc2)[TM][4],
                                         const float* l1, const float* l2, const float* r1,
                                         const float* r2, int rs, int ld) {
#pragma unroll
  for (int row = 0; row < TM; ++row) {
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      acc1[row][c] = 0.f;
      acc2[row][c] = 0.f;
    }
  }
  for (int m = 0; m < ld; m += 4) {
    if constexpr (kShareL) {
      float4 rv1[4], rv2[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        rv1[q] = ld4(r1 + (m + q) * ld);
        rv2[q] = ld4(r2 + (m + q) * ld);
      }
#pragma unroll
      for (int row = 0; row < TM; ++row) {
        const float4 lv = ld4(l1 + row * rs + m);
        fma4(acc1[row], lv, rv1);
        fma4(acc2[row], lv, rv2);
      }
    } else {
      float4 rv[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) rv[q] = ld4(r1 + (m + q) * ld);
#pragma unroll
      for (int row = 0; row < TM; ++row) {
        fma4(acc1[row], ld4(l1 + row * rs + m), rv);
        fma4(acc2[row], ld4(l2 + row * rs + m), rv);
      }
    }
  }
}

// acc = 1.5 x - 0.5 acc, x the same tile of another matrix
template <int TM>
__device__ __forceinline__ void finish(float (&acc)[TM][4], const float* x, int rs) {
#pragma unroll
  for (int row = 0; row < TM; ++row) {
    const float4 xv = ld4(x + row * rs);
    acc[row][0] = 1.5f * xv.x - 0.5f * acc[row][0];
    acc[row][1] = 1.5f * xv.y - 0.5f * acc[row][1];
    acc[row][2] = 1.5f * xv.z - 0.5f * acc[row][2];
    acc[row][3] = 1.5f * xv.w - 0.5f * acc[row][3];
  }
}

template <int TM>
__device__ __forceinline__ void store(float* out, const float (&t)[TM][4], int rs) {
#pragma unroll
  for (int row = 0; row < TM; ++row) {
    *reinterpret_cast<float4*>(out + row * rs) =
        make_float4(t[row][0], t[row][1], t[row][2], t[row][3]);
  }
}

// max |t - I| over the tile's elements inside the k x k matrix; the tile's
// rows are ti, ti + nti, ..., its columns j0 .. j0 + 3
template <int TM>
__device__ __forceinline__ float tile_resid(const float (&t)[TM][4], int ti, int nti, int j0,
                                            int k) {
  float r = 0.f;
#pragma unroll
  for (int row = 0; row < TM; ++row) {
    const int i = ti + row * nti;
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int j = j0 + c;
      if (i < k && j < k) r = max_nan(r, fabsf(t[row][c] - (i == j ? 1.f : 0.f)));
    }
  }
  return r;
}

// One block per matrix; nti x ntj tiles of TM x 4, one per thread (threads
// beyond the tiles only take part in the barriers and the matrix passes).
// Shared memory: W, Z, P of rows x 4 ntj floats each, then kRedFloats.  kNti
// and kNtj, where not 0, are the tile counts as constants; kThreads is the
// most threads a launch of the instance has.
template <int TM, bool kRmul, int kNti, int kNtj, int kThreads>
__global__ void __launch_bounds__(kThreads)
ns_invsqrt_kernel(const float* __restrict__ a, float* __restrict__ z_out,
                  int* __restrict__ iters_out, float* __restrict__ resid_out, int k, int nti_arg,
                  int ntj_arg, float inflat, float tol, int max_iters) {
  extern __shared__ __align__(16) float smem[];
  // the tile counts, known to the compiler where the launch says so: shared
  // memory offsets are then immediates, not multiplications
  const int nti = kNti ? kNti : nti_arg;
  const int ntj = kNtj ? kNtj : ntj_arg;
  const int ld = 4 * ntj;  // leading dimension = inner indices: k rounded up to 4
  // whole tiles of rows, and every inner index as a row of a right operand
  const int rows = nti * TM > ld ? nti * TM : ld;
  const int size = rows * ld;
  float* const w = smem;
  float* const z = smem + size;
  float* const p = smem + 2 * size;
  float* const red = smem + 3 * size;
  const int tid = threadIdx.x;
  const int n_threads = blockDim.x;
  const size_t base = static_cast<size_t>(blockIdx.x) * k * k;

  // The matrix passes (load, scale, write out) deal the buffer's float4
  // chunks to the threads, chunk tid + u n_threads to thread tid, all of a
  // thread's chunks in flight at once.  At most kChunks each: there are
  // rows ntj chunks and at least nti ntj threads, and rows < nti TM + 4.  (i, q) is a
  // chunk's row and column group; it walks by the block's stride, with no
  // division per chunk.
  constexpr int kChunks = TM + 1;
  const int n_chunks = rows * ntj;
  const int step_i = n_threads / ntj;
  const int step_q = n_threads - step_i * ntj;
  const int first_i = tid / ntj;
  const int first_q = tid - first_i * ntj;

  // W = a + inflat I (zero padded, kept in registers too), Z = I, P = 0
  float4 v[kChunks];
  {
    int i = first_i;
    int q = first_q;
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int idx = tid + u * n_threads;
      const int j = 4 * q;
      float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
      if (idx < n_chunks && i < k) {
        const float* src = a + base + i * k + j;
        if (j < k) x.x = src[0];
        if (j + 1 < k) x.y = src[1];
        if (j + 2 < k) x.z = src[2];
        if (j + 3 < k) x.w = src[3];
      }
      v[u] = x;
      i += step_i;
      q += step_q;
      if (q >= ntj) {
        q -= ntj;
        ++i;
      }
    }
    i = first_i;
    q = first_q;
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int idx = tid + u * n_threads;
      const int d = i - 4 * q;  // the diagonal's place in the chunk, if 0..3 and i < k
      float4 e = make_float4(0.f, 0.f, 0.f, 0.f);
      if (i < k) {
        if (d == 0) { v[u].x += inflat; e.x = 1.f; }
        if (d == 1) { v[u].y += inflat; e.y = 1.f; }
        if (d == 2) { v[u].z += inflat; e.z = 1.f; }
        if (d == 3) { v[u].w += inflat; e.w = 1.f; }
      }
      if (idx < n_chunks) {
        *reinterpret_cast<float4*>(w + 4 * idx) = v[u];
        *reinterpret_cast<float4*>(z + 4 * idx) = e;
        *reinterpret_cast<float4*>(p + 4 * idx) = make_float4(0.f, 0.f, 0.f, 0.f);
      }
      i += step_i;
      q += step_q;
      if (q >= ntj) {
        q -= ntj;
        ++i;
      }
    }
  }
  __syncthreads();

  // Gershgorin bound on lam_max, 1.9x looser (same scale as the plain
  // version); a row is summed left to right (its zero padding adds nothing)
  float rowsum = 0.f;
  for (int i = tid; i < k; i += n_threads) {
    float s = 0.f;
    for (int j = 0; j < ld; j += 4) {
      const float4 x = ld4(w + i * ld + j);
      s += fabsf(x.x);
      s += fabsf(x.y);
      s += fabsf(x.z);
      s += fabsf(x.w);
    }
    rowsum = max_nan(rowsum, s);
  }
  const float c = max_nan(block_max(rowsum, red) / 1.9f, FLT_MIN);
  const float c_inv = 1.f / c;

  // W_0 = A / c from the registers, and the first residual
  float r_part = 0.f;
  {
    int i = first_i;
    int q = first_q;
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int idx = tid + u * n_threads;
      float4 x = v[u];
      x.x = div_by(x.x, c, c_inv);
      x.y = div_by(x.y, c, c_inv);
      x.z = div_by(x.z, c, c_inv);
      x.w = div_by(x.w, c, c_inv);
      if (idx < n_chunks) *reinterpret_cast<float4*>(w + 4 * idx) = x;
      const int j = 4 * q;
      if (idx < n_chunks && i < k) {
        if (j < k) r_part = max_nan(r_part, fabsf(x.x - (i == j ? 1.f : 0.f)));
        if (j + 1 < k) r_part = max_nan(r_part, fabsf(x.y - (i == j + 1 ? 1.f : 0.f)));
        if (j + 2 < k) r_part = max_nan(r_part, fabsf(x.z - (i == j + 2 ? 1.f : 0.f)));
        if (j + 3 < k) r_part = max_nan(r_part, fabsf(x.w - (i == j + 3 ? 1.f : 0.f)));
      }
      i += step_i;
      q += step_q;
      if (q >= ntj) {
        q -= ntj;
        ++i;
      }
    }
  }
  float r_cur = block_max(r_part, red);  // max |W - I| of the current W

  // this thread's tile: rows ti + row * nti, columns j0 .. j0 + 3; lanes run
  // along a row strip first
  const bool active = tid < nti * ntj;
  const int ti = active ? tid / ntj : 0;
  const int j0 = active ? 4 * (tid - ti * ntj) : 0;
  const int rs = nti * ld;      // between two rows of a tile
  const int l_off = ti * ld;    // the tile's first row of a left operand
  const int t_off = l_off + j0; // the tile's first element
  const int lane = tid & 31;
  const int warp = tid >> 5;

  int it = 0;
  float resid = INFINITY;
  while (resid > tol && it < max_iters) {  // uniform across the block; a NaN stops too
    resid = r_cur;
    float t1[TM][4];
    float t2[TM][4];
    if (active) {
      product<TM>(t1, w + l_off, w + j0, rs, ld);
      finish<TM>(t1, w + t_off, rs);
      store<TM>(p + t_off, t1, rs);  // P = T W = W T
    }
    __syncthreads();
    float r_new = 0.f;
    if (active) {
      if constexpr (kRmul) {  // Z T and P T
        product2<TM, false>(t1, t2, z + l_off, p + l_off, w + j0, w + j0, rs, ld);
      } else {  // T Z and T P
        product2<TM, true>(t1, t2, w + l_off, w + l_off, z + j0, p + j0, rs, ld);
      }
      finish<TM>(t1, z + t_off, rs);
      finish<TM>(t2, p + t_off, rs);
      r_new = tile_resid<TM>(t2, ti, nti, j0, k);
    }
    r_new = warp_max(r_new);
    if (lane == 0) red[warp] = r_new;
    __syncthreads();  // every read of the old Z and W is done
    if (active) {
      store<TM>(z + t_off, t1, rs);
      store<TM>(w + t_off, t2, rs);
    }
    r_cur = red_max(red);
    __syncthreads();
    ++it;
  }

  const float sc = sqrtf(c);
  const float sc_inv = 1.f / sc;
  {
    int i = first_i;
    int q = first_q;
#pragma unroll
    for (int u = 0; u < kChunks; ++u) {
      const int idx = tid + u * n_threads;
      const int j = 4 * q;
      if (idx < n_chunks && i < k) {
        const float4 x = ld4(z + 4 * idx);
        float* dst = z_out + base + i * k + j;
        if (j < k) dst[0] = div_by(x.x, sc, sc_inv);
        if (j + 1 < k) dst[1] = div_by(x.y, sc, sc_inv);
        if (j + 2 < k) dst[2] = div_by(x.z, sc, sc_inv);
        if (j + 3 < k) dst[3] = div_by(x.w, sc, sc_inv);
      }
      i += step_i;
      q += step_q;
      if (q >= ntj) {
        q -= ntj;
        ++i;
      }
    }
  }
  if (tid == 0) {
    iters_out[blockIdx.x] = it;
    resid_out[blockIdx.x] = resid;
  }
}

using Kernel = void (*)(const float*, float*, int*, float*, int, int, int, float, float, int);

struct Plan {
  Kernel kernel;
  int tm, nti, ntj, threads;
  size_t smem;
};

Plan plan_for(int k, int rmul) {
  constexpr int kT8 = kTiles96 / 8;
  constexpr int kT6 = kTiles96 / 6;
  constexpr int kT128 = kTiles128 / 8;
  Plan pl;
  const int tm = k <= kWideK || k > kMidK ? 8 : 6;
  if (k == 40) {  // the bench case's ensemble
    pl.kernel = rmul ? ns_invsqrt_kernel<8, true, 5, 10, kT8>
                     : ns_invsqrt_kernel<8, false, 5, 10, kT8>;
  } else if (k == 96) {  // the production namelist's ensemble
    pl.kernel = rmul ? ns_invsqrt_kernel<6, true, 16, 24, kT6>
                     : ns_invsqrt_kernel<6, false, 16, 24, kT6>;
  } else if (k > kMidK) {
    pl.kernel = rmul ? ns_invsqrt_kernel<8, true, 0, 0, kT128>
                     : ns_invsqrt_kernel<8, false, 0, 0, kT128>;
  } else if (tm == 6) {
    pl.kernel = rmul ? ns_invsqrt_kernel<6, true, 0, 0, kT6>
                     : ns_invsqrt_kernel<6, false, 0, 0, kT6>;
  } else {
    pl.kernel = rmul ? ns_invsqrt_kernel<8, true, 0, 0, kT8>
                     : ns_invsqrt_kernel<8, false, 0, 0, kT8>;
  }
  pl.tm = tm;
  pl.nti = (k + tm - 1) / tm;
  pl.ntj = (k + 3) / 4;
  pl.threads = (pl.nti * pl.ntj + 31) / 32 * 32;
  const int ld = 4 * pl.ntj;  // as the kernel lays its buffers out
  const int rows = pl.nti * tm > ld ? pl.nti * tm : ld;
  pl.smem = (3 * static_cast<size_t>(rows) * ld + kRedFloats) * sizeof(float);
  return pl;
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

// a: [batch, k, k] float32, contiguous.  z: same shape.  iters, resid: [batch].
// rmul selects the K2 variant.  Launches on `stream` and returns
// cudaGetLastError() after the launch.
extern "C" int ns_invsqrt_f32(const float* a, float* z, int* iters, float* resid, int batch, int k,
                              float inflat, float tol, int max_iters, int rmul, void* stream) {
  if (batch <= 0 || k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_for(k, rmul);
  const cudaError_t err = prepare(pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  pl.kernel<<<batch, pl.threads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      a, z, iters, resid, k, pl.nti, pl.ntj, inflat, tol, max_iters);
  return static_cast<int>(cudaGetLastError());
}

// What a launch at ensemble size k uses: out[0..4] = threads per block,
// dynamic shared memory in bytes, registers per thread, resident blocks per
// SM, tile rows.  Launches nothing.  Returns a CUDA error code.
extern "C" int ns_invsqrt_config(int k, int rmul, int* out) {
  if (k < 1 || k > kMaxK) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_for(k, rmul);
  cudaError_t err = prepare(pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const void* fn = reinterpret_cast<const void*>(pl.kernel);
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, fn);
  if (err != cudaSuccess) return static_cast<int>(err);
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, fn, pl.threads, pl.smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  out[0] = pl.threads;
  out[1] = static_cast<int>(pl.smem);
  out[2] = attr.numRegs;
  out[3] = blocks;
  out[4] = pl.tm;
  return 0;
}
