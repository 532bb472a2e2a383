// K6, the selected-pair accumulation: each point's localization-weighted
// normal terms, summed over the records that the cap search (K5) selected.
//
// Replaces no TPU kernel: the JAX package forms these terms with one dense
// product of a [C, R] weight matrix and the [R, k (k + 1)] fused table
// (cwbnwp_letkf_tpu/ops/dense.py, terms_from_r2), and so did the port
// (ops/dense.py::terms_from_r2).  Where the max_lz_pts cap binds, a point keeps
// at most n_max (300 for vr) of a call's 6,000-14,300 records, so 95-98% of
// that product's pairs weigh zero, and it was the port's largest layer.  This
// kernel takes the capped branch of terms_from_r2 on a card, after K5.
//
// What it computes, for each point c (a row of r2 [C, R] and of sel [C, R]):
//
//   for each record j with sel[c, j] and nvalid[j] > 0, in ascending j,
//     w = exp(-r2/2) (Gaussian), or GC1999(sqrt(r2)) where gc != 0
//     for each observed variable v:
//       s = w e[j, v]
//       a[c, i, l] += (s bgo[j, v, i]) bgo[j, v, l]     i, l < k
//       g[c, i]    += (s bgo[j, v, i]) bgo[j, v, k]     (bgo[j, v, k] = omm)
//   count[c] = the sum of nvalid[j] over the selected records
//
// with bgo = [bg | omm] and e = (valid & assim) / err^2
// (ops/dense.py::pair_factors).  That is terms_from_r2's product with the
// fused rows sum_v (e bg) (x) [bg | omm] multiplied out: the same terms, the
// sum in another order.  A record's nvalid is 0 exactly where its every e is
// 0, so leaving such records out drops only zeros.  The weights are rounded
// one operation at a time (no contraction into FMAs), as PyTorch's
// elementwise kernels round terms_from_r2's.
//
// What bounds it on this card: the float32 FMAs, 2 k (k + 1) operations a
// selected (record, variable): 11.4 GFLOP for the production slab's chunk
// [2048, ~14,300] at k = 96 with 300 records a point, 0.17 ms at 67 TFLOP/s.
// Its bytes are a byte of sel a pair, the selected pairs' r2, the records'
// factors (k + 2 floats a variable, read once from device memory and then
// mostly from L2) and the outputs: about 0.03 ms at 3.35 TB/s.  The dense
// product it replaces reads a k (k + 1) row of the table for every pair.  The
// design:
//   - one block of 256 threads (16 x 16) a point, for k <= 128; above, a few
//     blocks a point, each one 96 x 192 tile of the point's k x (k + 1)
//     terms.  No work is shared between blocks, so nothing is summed across
//     them;
//   - the point's selection is compacted on chip: the block walks its row of
//     sel in segments of 2,048 records, eight a thread (the records' sel and
//     nvalid read together), and a block-wide prefix sum puts each selected
//     record's index and weight in a list in shared memory, in ascending
//     order.  Any n_max works: whole batches are taken out of the list after
//     each segment and the rest carried over;
//   - the listed records are staged in batches of 64 (record, variable) rows
//     in shared memory: s bg over the block's rows (U) and [bg | omm] over its
//     columns (W), each factor read once where the point is one tile.  Two
//     barriers a batch; the latency of its loads is hidden by the SM's other
//     block;
//   - each thread keeps an MR x MC micro-tile of the sum in registers, rows
//     ty + 16 a and columns tx + 16 b of the block's tile.  A staged row costs
//     it MR reads of U (two addresses a warp: broadcast), MC reads of W (16
//     consecutive floats: no bank conflict) and MR x MC FMAs;
//   - the tile follows k at run time: MR = ceil(k / 16) and MC =
//     ceil((k + 1) / 16) up to k = 128 (17 instances, the largest 8 x 9), the
//     6 x 12 tile above.  Rows and columns past k are staged as zeros and
//     never written.
// Full float32 throughout: FMAs on the CUDA cores, no TF32 and no tensor
// cores.  It launches on the caller's stream, allocates nothing, does not
// synchronise, and select_terms_f32 returns cudaGetLastError().
#include <cuda_runtime.h>

#include <cmath>
#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kSide = 16;  // the block's threads, kSide x kSide
constexpr int kWarps = kThreads / 32;
constexpr int kScan = 8;  // records a thread examines in a segment
constexpr int kSegment = kThreads * kScan;
constexpr int kBatchRows = 64;  // staged (record, variable) rows a batch
constexpr int kSingleMax = 8;   // one block a point up to MR = 8 (k <= 128)
constexpr int kBigMR = 6, kBigMC = 12;
constexpr unsigned kFull = 0xffffffffu;

// localization.py's constants, each rounded to float32 as PyTorch rounds a
// Python scalar: 1 / sqrt(10/3) (the division by a scalar is a multiply by its
// reciprocal on a card), 1/12, 2/3 and 5/3
constexpr float kGcA = static_cast<float>(1.8257418583505538);
constexpr float kGcInvA = 1.0f / kGcA;
constexpr float kTwelfth = static_cast<float>(1.0 / 12.0);
constexpr float kTwoThirds = static_cast<float>(2.0 / 3.0);
constexpr float kFiveThirds = static_cast<float>(5.0 / 3.0);

// exp(-0.5 r2): terms_from_r2's Gaussian weight.
__device__ __forceinline__ float gaussian(float r2) { return expf(__fmul_rn(-0.5f, r2)); }

// gaspari_cohn_1999(sqrt(r2)), localization.py's operations in its order.
__device__ __forceinline__ float gc1999(float r2) {
  const float z = __fmul_rn(sqrtf(r2), kGcInvA);
  const float z2 = __fmul_rn(z, z);
  float t = __fadd_rn(__fmul_rn(-0.25f, z), 0.5f);
  t = __fadd_rn(__fmul_rn(z, t), 0.625f);
  t = __fsub_rn(__fmul_rn(z, t), kFiveThirds);
  const float inner = __fadd_rn(__fmul_rn(z2, t), 1.0f);
  const float zs = fmaxf(z, 1e-30f);
  float o = __fsub_rn(__fmul_rn(kTwelfth, z), 0.5f);
  o = __fadd_rn(__fmul_rn(z, o), 0.625f);
  o = __fadd_rn(__fmul_rn(z, o), kFiveThirds);
  o = __fsub_rn(__fmul_rn(z, o), 5.0f);
  o = __fadd_rn(__fmul_rn(z, o), 4.0f);
  o = __fsub_rn(o, __fmul_rn(__frcp_rn(zs), kTwoThirds));
  const float w = z <= 1.0f ? inner : (z <= 2.0f ? o : 0.0f);
  return fmaxf(w, 0.0f);
}

// Shared memory of a block: rows = the batch's (record, variable) rows,
// list = kSegment + entries a batch.
struct Smem {
  float* u;       // [rows][16 MR]
  float* w;       // [rows][16 MC]
  float* list_w;  // [list] weight of each listed record
  int* list_j;    // [list] its index
  int* row_ent;   // [rows] a staged row's record in the batch
  int* row_var;   // [rows] and its variable
};

__device__ __forceinline__ Smem carve(void* base, int rows, int rows_tile, int cols_tile, int list) {
  Smem s;
  s.u = static_cast<float*>(base);
  s.w = s.u + rows * rows_tile;
  s.list_w = s.w + rows * cols_tile;
  s.list_j = reinterpret_cast<int*>(s.list_w + list);
  s.row_ent = s.list_j + list;
  s.row_var = s.row_ent + rows;
  return s;
}

// Adds the listed records first .. first + n - 1 to the micro-tile: stages
// their rows, then one FMA sweep.  Leaves after a barrier, so the stage and
// the list may be written again.  With one tile a point (kOneTile: rows and
// columns both start at 0, 16 MR <= 16 MC) each factor is read once, for W
// and for U.
template <int MR, int MC, bool kOneTile>
__device__ __forceinline__ void accumulate_batch(float (&acc)[MR][MC], const Smem& sm, int first,
                                                 int n, const float* __restrict__ bgo,
                                                 const float* __restrict__ e, int k, int nv,
                                                 int row0, int col0, int tx, int ty) {
  constexpr int kRowsTile = kSide * MR, kColsTile = kSide * MC;
  const int rows = n * nv;
  const int width = k + 1;
  for (int idx = threadIdx.x; idx < rows * kColsTile; idx += kThreads) {
    const int q = idx / kColsTile, l = idx % kColsTile;
    const int ent = sm.row_ent[q];
    const long long rv = static_cast<long long>(sm.list_j[first + ent]) * nv + sm.row_var[q];
    const float* row = bgo + rv * width;
    const float x = col0 + l <= k ? __ldg(row + col0 + l) : 0.0f;
    sm.w[idx] = x;
    if (kOneTile && l < kRowsTile) {
      const float s = __fmul_rn(sm.list_w[first + ent], __ldg(e + rv));
      sm.u[q * kRowsTile + l] = l < k ? __fmul_rn(s, x) : 0.0f;
    }
  }
  if (!kOneTile) {
    for (int idx = threadIdx.x; idx < rows * kRowsTile; idx += kThreads) {
      const int q = idx / kRowsTile, i = row0 + idx % kRowsTile;
      const int ent = sm.row_ent[q];
      const long long rv = static_cast<long long>(sm.list_j[first + ent]) * nv + sm.row_var[q];
      const float s = __fmul_rn(sm.list_w[first + ent], __ldg(e + rv));
      sm.u[idx] = i < k ? __fmul_rn(s, __ldg(bgo + rv * width + i)) : 0.0f;
    }
  }
  __syncthreads();
#pragma unroll 1
  for (int q = 0; q < rows; ++q) {
    float u[MR], w[MC];
#pragma unroll
    for (int a = 0; a < MR; ++a) u[a] = sm.u[q * kRowsTile + ty + kSide * a];
#pragma unroll
    for (int b = 0; b < MC; ++b) w[b] = sm.w[q * kColsTile + tx + kSide * b];
#pragma unroll
    for (int a = 0; a < MR; ++a) {
#pragma unroll
      for (int b = 0; b < MC; ++b) acc[a][b] = fmaf(u[a], w[b], acc[a][b]);
    }
  }
  __syncthreads();
}

// Block (c, y, z): point c, rows 16 MR y .., columns 16 MC z .. of its
// k x (k + 1) terms.  r2, sel [batch, n]; bgo [n, nv, k + 1]; e [n, nv];
// nvalid [n]; a [batch, k, k], g [batch, k], count [batch].
template <int MR, int MC, bool kOneTile>
__global__ void __launch_bounds__(kThreads, 2)
    select_terms_kernel(const float* __restrict__ r2, const uint8_t* __restrict__ sel,
                        const float* __restrict__ bgo, const float* __restrict__ e,
                        const int* __restrict__ nvalid, float* __restrict__ a_out,
                        float* __restrict__ g_out, int* __restrict__ count_out, int n, int k,
                        int nv, int gc, int entries) {
  constexpr int kRowsTile = kSide * MR, kColsTile = kSide * MC;
  extern __shared__ float smem_raw[];
  __shared__ int warp_sums[kWarps];
  const int rows = entries * nv;
  const Smem sm = carve(smem_raw, rows, kRowsTile, kColsTile, kSegment + entries);
  for (int q = threadIdx.x; q < rows; q += kThreads) sm.row_ent[q] = q / nv, sm.row_var[q] = q % nv;
  const int c = blockIdx.x;
  const int row0 = blockIdx.y * kRowsTile, col0 = blockIdx.z * kColsTile;
  const int tx = threadIdx.x % kSide, ty = threadIdx.x / kSide;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const float* r2_row = r2 + static_cast<size_t>(c) * n;
  const uint8_t* sel_row = sel + static_cast<size_t>(c) * n;

  float acc[MR][MC];
#pragma unroll
  for (int a = 0; a < MR; ++a) {
#pragma unroll
    for (int b = 0; b < MC; ++b) acc[a][b] = 0.0f;
  }
  int count = 0;   // this thread's part of count[c]
  int listed = 0;  // records in the list, the same in every thread
  for (int base = 0; base < n; base += kSegment) {
    const int j0 = base + kScan * threadIdx.x;
    int mine = 0;
    unsigned flags = 0;
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      const int j = j0 + q;
      if (j < n) {  // both loads at once: nvalid is read whether or not selected
        const bool picked = sel_row[j];
        const int nvj = __ldg(nvalid + j);
        if (picked) {
          count += nvj;
          if (nvj > 0) flags |= 1u << q, ++mine;
        }
      }
    }
    int incl = mine;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int up = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += up;
    }
    if (lane == 31) warp_sums[warp] = incl;
    __syncthreads();
    int before = 0, total = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int s = warp_sums[w];
      before += w < warp ? s : 0;
      total += s;
    }
    int pos = listed + before + incl - mine;
#pragma unroll
    for (int q = 0; q < kScan; ++q) {
      if (flags >> q & 1u) {
        const float d2 = __ldg(r2_row + j0 + q);
        sm.list_j[pos] = j0 + q;
        sm.list_w[pos] = gc ? gc1999(d2) : gaussian(d2);
        ++pos;
      }
    }
    listed += total;
    __syncthreads();
    int done = 0;
    for (; listed - done >= entries; done += entries)
      accumulate_batch<MR, MC, kOneTile>(acc, sm, done, entries, bgo, e, k, nv, row0, col0, tx,
                                         ty);
    if (done > 0) {  // carry the rest (fewer than `entries`) to the front
      const int left = listed - done, t = threadIdx.x;
      int lj = 0;
      float lw = 0.0f;
      if (t < left) lj = sm.list_j[done + t], lw = sm.list_w[done + t];
      __syncthreads();
      if (t < left) sm.list_j[t] = lj, sm.list_w[t] = lw;
      listed = left;
    }
  }
  if (listed > 0) {
    __syncthreads();  // the carried records are in place
    accumulate_batch<MR, MC, kOneTile>(acc, sm, 0, listed, bgo, e, k, nv, row0, col0, tx, ty);
  }

  if (blockIdx.y == 0 && blockIdx.z == 0) {
    const int sum = __reduce_add_sync(kFull, count);
    if (lane == 0) warp_sums[warp] = sum;
    __syncthreads();
    if (threadIdx.x == 0) {
      int total = 0;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) total += warp_sums[w];
      count_out[c] = total;
    }
  }
  float* a_row = a_out + static_cast<size_t>(c) * k * k;
#pragma unroll
  for (int a = 0; a < MR; ++a) {
    const int i = row0 + ty + kSide * a;
    if (i >= k) continue;
#pragma unroll
    for (int b = 0; b < MC; ++b) {
      const int l = col0 + tx + kSide * b;
      if (l < k)
        a_row[static_cast<size_t>(i) * k + l] = acc[a][b];
      else if (l == k)
        g_out[static_cast<size_t>(c) * k + i] = acc[a][b];
    }
  }
}

using Kernel = void (*)(const float*, const uint8_t*, const float*, const float*, const int*,
                        float*, float*, int*, int, int, int, int, int);

// [MR - 1][MC - MR]: MC is MR, or MR + 1 where k is a multiple of 16
const Kernel kSingle[kSingleMax][2] = {
    {select_terms_kernel<1, 1, true>, select_terms_kernel<1, 2, true>},
    {select_terms_kernel<2, 2, true>, select_terms_kernel<2, 3, true>},
    {select_terms_kernel<3, 3, true>, select_terms_kernel<3, 4, true>},
    {select_terms_kernel<4, 4, true>, select_terms_kernel<4, 5, true>},
    {select_terms_kernel<5, 5, true>, select_terms_kernel<5, 6, true>},
    {select_terms_kernel<6, 6, true>, select_terms_kernel<6, 7, true>},
    {select_terms_kernel<7, 7, true>, select_terms_kernel<7, 8, true>},
    {select_terms_kernel<8, 8, true>, select_terms_kernel<8, 9, true>},
};

struct Plan {
  Kernel kernel;
  int mr, mc;        // the micro-tile
  dim3 tiles;        // blocks a point: 1, row tiles, column tiles
  int entries;       // records a batch
  size_t smem;       // dynamic shared memory, bytes
};

Plan plan_for(int k, int nv) {
  Plan p;
  const int rt = (k + kSide - 1) / kSide, ct = k / kSide + 1;  // ceil(k/16), ceil((k+1)/16)
  if (rt <= kSingleMax) {
    p.kernel = kSingle[rt - 1][ct - rt];
    p.mr = rt, p.mc = ct;
    p.tiles = dim3(1, 1, 1);
  } else {
    p.kernel = select_terms_kernel<kBigMR, kBigMC, false>;
    p.mr = kBigMR, p.mc = kBigMC;
    p.tiles = dim3(1, (k + kSide * kBigMR - 1) / (kSide * kBigMR),
                   (k + kSide * kBigMC) / (kSide * kBigMC));
  }
  p.entries = nv >= kBatchRows ? 1 : kBatchRows / nv;
  const size_t rows = static_cast<size_t>(p.entries) * nv;
  const size_t list = static_cast<size_t>(kSegment) + p.entries;
  p.smem = rows * kSide * (p.mr + p.mc) * sizeof(float) + list * (sizeof(float) + sizeof(int)) +
           2 * rows * sizeof(int);
  return p;
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

// r2: [batch, n] float32; sel: [batch, n] bytes 0 / 1; bgo: [n, nv, k + 1]
// float32; e: [n, nv] float32; nvalid: [n] int32; all contiguous.  Writes
// a: [batch, k, k], g: [batch, k] float32 and count: [batch] int32.  gc: 1
// for the Gaspari-Cohn weight, 0 for the Gaussian.  Launches on `stream` and
// returns cudaGetLastError() after the launch; a batch of 0 launches nothing.
extern "C" int select_terms_f32(const float* r2, const uint8_t* sel, const float* bgo,
                                const float* e, const int* nvalid, float* a, float* g,
                                int* count, int batch, int n, int k, int nv, int gc,
                                void* stream) {
  if (batch < 0 || n < 1 || k < 1 || nv < 1) return static_cast<int>(cudaErrorInvalidValue);
  if (batch == 0) return 0;
  const Plan pl = plan_for(k, nv);
  const cudaError_t err = prepare(pl);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(batch, pl.tiles.y, pl.tiles.z);
  pl.kernel<<<grid, kThreads, pl.smem, static_cast<cudaStream_t>(stream)>>>(
      r2, sel, bgo, e, nvalid, a, g, count, n, k, nv, gc ? 1 : 0, pl.entries);
  return static_cast<int>(cudaGetLastError());
}

// What a launch at k and nv observed variables uses: out[0..7] = threads a
// block, dynamic shared memory in bytes, registers a thread, resident blocks
// an SM, the micro-tile's rows and columns (MR, MC), blocks a point, and
// records a batch.  Launches nothing.  Returns a CUDA error code.
extern "C" int select_terms_config(int k, int nv, int* out) {
  if (k < 1 || nv < 1) return static_cast<int>(cudaErrorInvalidValue);
  const Plan pl = plan_for(k, nv);
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
  out[4] = pl.mr;
  out[5] = pl.mc;
  out[6] = static_cast<int>(pl.tiles.y * pl.tiles.z);
  out[7] = pl.entries;
  return 0;
}
