// Fused filtered-rank counts for entity-ranking evaluation on Hopper.
//
// Replaces the TPU kernel kge_tpu/ops/rank_kernel.py fused_rank_counts
// (body _kernel, tie rule _close_greater). For each query row i it computes
// the scores s_ij = q_i . t_j of every candidate column j < num_valid and
//   greater[i] = #{j : s_ij > pivot_i and not close}
//   close[i]   = #{j : |s_ij - pivot_i| <= atol + rtol |pivot_i|}
// with NaN read as -inf and two -inf counted as close, and it writes the
// scores at the row's label columns (CSR: row_ptr, cols ascending per row)
// into vals. The [n, num_valid] score matrix is never stored.
//
// Layout: one block owns BM query rows and walks every candidate column in
// tiles of BN columns; the TPU's sequential entity grid axis becomes this
// loop. Counts live in registers and are reduced inside the block at the
// end: no atomics, and the result does not depend on scheduling.
//
// Precision: every score is one float32 FMA chain over d in ascending
// order (__fmaf_rn, no split over d, no TF32, no tensor cores). A score
// therefore has the same bits wherever it is computed: in a tile, in the
// pivot (pivot_i = q_i . t_{pivot_cols[i]}, computed the same way), and in
// vals. The true column ties with itself exactly, and a caller that
// recounts a label from vals reproduces the kernel's decision.
//
// Bound: at evaluation shapes (n = 256, |E| = 14,541, D = 512) the work is
// 2 n |E| D flops against n D + |E| D floats of input, about 60 flops per
// byte, so the card's fp32 CUDA-core rate bounds it, not memory. What this
// version does about it: the q tile stays in shared memory for the whole
// walk; BK-deep slices of the candidate tile stream in with cp.async,
// double-buffered so the next slice loads while this one is multiplied;
// each thread holds BM x CPT accumulators and reads q by broadcast and its
// candidate columns as float4 without bank conflicts.
//
// What it does not do yet: a block owns BM = 4 rows and takes 168 KiB of
// shared memory (two 80 KiB candidate slices and the 8 KiB q tile at
// D = 512), so one block fits an SM. At n = 256 the grid is 64 blocks, and 68 of an H100's 132 SMs stay
// idle: about half of the gap to the bound. It does not use wgmma or TMA
// either: a later version that does must keep the ascending-order agreement
// between tile, pivot and vals.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BM = 4;               // query rows per block
constexpr int THREADS = 256;        // threads per block
constexpr int CPT = 4;              // candidate columns per thread
constexpr int BN = THREADS * CPT;   // candidate columns per tile
constexpr int BK = 16;              // depth of one staged candidate slice
constexpr int TS_STRIDE = BK + 4;   // padded column of a slice (floats)
constexpr int TS_FLOATS = BN * TS_STRIDE;
constexpr int WARPS = THREADS / 32;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

__device__ __forceinline__ int lower_bound(const int32_t* a, int lo, int hi,
                                           int value) {
  while (lo < hi) {
    int mid = (lo + hi) >> 1;
    if (a[mid] < value) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The tie rule of kge_tpu's _close_greater, with each float operation
// rounded on its own (no contraction into an FMA) as the plain version does.
__device__ __forceinline__ void close_greater(float s, float p, float tol,
                                              int& is_close, int& is_greater) {
  s = isnan(s) ? -INFINITY : s;
  bool finite = isfinite(s) || isfinite(p);
  bool close = fabsf(__fsub_rn(s, p)) <= tol;
  bool both_neg_inf = (s == -INFINITY) && (p == -INFINITY);
  close = both_neg_inf || (close && finite);
  is_close = close ? 1 : 0;
  is_greater = (s > p && !close) ? 1 : 0;
}

// Stage the slice [k0, k0 + BK) of candidate columns [c0, c0 + BN) into ts
// as ts[j * TS_STRIDE + kk]; entries past num_valid or D are zero-filled.
__device__ __forceinline__ void stage_slice(float* ts, const float* t, int c0,
                                            int k0, int D, int num_valid,
                                            bool vec) {
  const int kw = min(BK, D - k0);
  if (vec) {
    for (int idx = threadIdx.x; idx < BN * (BK / 4); idx += THREADS) {
      int j = idx / (BK / 4);
      int kk = (idx - j * (BK / 4)) * 4;
      int col = c0 + j;
      bool ok = col < num_valid && kk < kw;
      const float* src = ok ? t + (size_t)col * D + k0 + kk : t;
      cp_async16(ts + j * TS_STRIDE + kk, src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < BN * BK; idx += THREADS) {
      int j = idx / BK;
      int kk = idx - j * BK;
      int col = c0 + j;
      bool ok = col < num_valid && kk < kw;
      const float* src = ok ? t + (size_t)col * D + k0 + kk : t;
      cp_async4(ts + j * TS_STRIDE + kk, src, ok ? 4 : 0);
    }
  }
  cp_async_commit();
}

// acc[r][h] += q[r][k0 + kk + i] * t[col h][kk + i] for i < min(4, left),
// in ascending i: four steps of each score's FMA chain.
__device__ __forceinline__ void multiply_step(float (&acc)[BM][CPT],
                                              const float* ts, const float* qs,
                                              int Dp, int k0, int kk,
                                              int left) {
  const int tid = threadIdx.x;
  float4 tv[CPT];
#pragma unroll
  for (int h = 0; h < CPT; ++h)
    tv[h] = *reinterpret_cast<const float4*>(
        ts + (tid + h * THREADS) * TS_STRIDE + kk);
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    const float4 qv = *reinterpret_cast<const float4*>(qs + r * Dp + k0 + kk);
#pragma unroll
    for (int h = 0; h < CPT; ++h) {
      float a = acc[r][h];
      a = __fmaf_rn(qv.x, tv[h].x, a);
      if (left > 1) a = __fmaf_rn(qv.y, tv[h].y, a);
      if (left > 2) a = __fmaf_rn(qv.z, tv[h].z, a);
      if (left > 3) a = __fmaf_rn(qv.w, tv[h].w, a);
      acc[r][h] = a;
    }
  }
}

__global__ void __launch_bounds__(THREADS)
rank_counts_kernel(const float* __restrict__ q, const float* __restrict__ t,
                   const int32_t* __restrict__ pivot_cols,
                   const int32_t* __restrict__ row_ptr,
                   const int32_t* __restrict__ cols, int n, int D,
                   int num_valid, float atol, float rtol,
                   int32_t* __restrict__ greater_out,
                   int32_t* __restrict__ close_out,
                   float* __restrict__ vals_out,
                   float* __restrict__ pivot_out) {
  extern __shared__ __align__(16) float smem[];
  const int Dp = (D + 3) & ~3;       // q row stride: float4-aligned
  float* ts0 = smem;                 // [BN][TS_STRIDE], two buffers
  float* ts1 = smem + TS_FLOATS;
  float* qs = smem + 2 * TS_FLOATS;  // [BM][Dp]
  __shared__ float piv[BM];
  __shared__ float tol[BM];
  __shared__ int seg_lo[2][BM];
  __shared__ int seg_hi[2][BM];
  __shared__ int red_g[WARPS][BM];
  __shared__ int red_c[WARPS][BM];

  const int tid = threadIdx.x;
  const int row0 = blockIdx.x * BM;
  // 16-byte copies need 16-byte aligned rows
  const bool vec = (D & 3) == 0 && (reinterpret_cast<uintptr_t>(t) & 15) == 0;
  const int n_ks = (D + BK - 1) / BK;
  const int n_tiles = (num_valid + BN - 1) / BN;
  const int total = n_tiles * n_ks;

  if (total > 0) stage_slice(ts0, t, 0, 0, D, num_valid, vec);

  for (int idx = tid; idx < BM * Dp; idx += THREADS) {
    int r = idx / Dp;
    int d = idx - r * Dp;
    int row = row0 + r;
    qs[idx] = (row < n && d < D) ? q[(size_t)row * D + d] : 0.0f;
  }
  __syncthreads();

  if (tid < BM) {
    int row = row0 + tid;
    float p = 0.0f;
    if (row < n) {
      const float* tr = t + (size_t)pivot_cols[row] * D;
      const float* qr = qs + tid * Dp;
      for (int d = 0; d < D; ++d) p = __fmaf_rn(qr[d], tr[d], p);
      pivot_out[row] = p;
    }
    p = isnan(p) ? -INFINITY : p;
    piv[tid] = p;
    tol[tid] = __fadd_rn(atol, __fmul_rn(rtol, fabsf(p)));
  }

  int g_cnt[BM];
  int c_cnt[BM];
  float acc[BM][CPT];
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    g_cnt[r] = 0;
    c_cnt[r] = 0;
#pragma unroll
    for (int h = 0; h < CPT; ++h) acc[r][h] = 0.0f;
  }

  for (int it = 0; it < total; ++it) {
    const int tile = it / n_ks;
    const int ks = it - tile * n_ks;
    const int c0 = tile * BN;
    const int k0 = ks * BK;
    const int kw = min(BK, D - k0);
    float* ts = (it & 1) ? ts1 : ts0;

    if (ks == 0 && tid < BM) {
      // this tile's label range of each row, for the epilogue
      int row = row0 + tid;
      int lo = 0, hi = 0;
      if (row < n) {
        int a = row_ptr[row], b = row_ptr[row + 1];
        lo = lower_bound(cols, a, b, c0);
        hi = lower_bound(cols, lo, b, c0 + BN);
      }
      seg_lo[tile & 1][tid] = lo;
      seg_hi[tile & 1][tid] = hi;
    }
    if (it + 1 < total) {
      const int nt = (it + 1) / n_ks;
      stage_slice((it & 1) ? ts0 : ts1, t, nt * BN, (it + 1 - nt * n_ks) * BK,
                  D, num_valid, vec);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();

    if (kw == BK) {
#pragma unroll
      for (int kk = 0; kk < BK; kk += 4)
        multiply_step(acc, ts, qs, Dp, k0, kk, 4);
    } else {
      for (int kk = 0; kk < kw; kk += 4)
        multiply_step(acc, ts, qs, Dp, k0, kk, kw - kk);
    }
    __syncthreads();  // the buffer just read is refilled next iteration

    if (ks == n_ks - 1) {
      const int lo_buf = tile & 1;
#pragma unroll
      for (int h = 0; h < CPT; ++h) {
        const int col = c0 + tid + h * THREADS;
#pragma unroll
        for (int r = 0; r < BM; ++r) {
          const float s = acc[r][h];
          acc[r][h] = 0.0f;
          if (col >= num_valid || row0 + r >= n) continue;
          int cl, gr;
          close_greater(s, piv[r], tol[r], cl, gr);
          g_cnt[r] += gr;
          c_cnt[r] += cl;
          const int lo = seg_lo[lo_buf][r], hi = seg_hi[lo_buf][r];
          if (lo < hi) {
            int pos = lower_bound(cols, lo, hi, col);
            if (pos < hi && cols[pos] == col) vals_out[pos] = s;
          }
        }
      }
    }
  }

  const int lane = tid & 31;
  const int warp = tid >> 5;
#pragma unroll
  for (int r = 0; r < BM; ++r) {
    int g = g_cnt[r], c = c_cnt[r];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      g += __shfl_down_sync(0xffffffffu, g, off);
      c += __shfl_down_sync(0xffffffffu, c, off);
    }
    if (lane == 0) {
      red_g[warp][r] = g;
      red_c[warp][r] = c;
    }
  }
  __syncthreads();
  if (tid < BM && row0 + tid < n) {
    int g = 0, c = 0;
    for (int w = 0; w < WARPS; ++w) {
      g += red_g[w][tid];
      c += red_c[w][tid];
    }
    greater_out[row0 + tid] = g;
    close_out[row0 + tid] = c;
  }
}

}  // namespace

extern "C" {

// Largest D the kernel takes: the q tile and two candidate slices must fit
// the 227 KB of shared memory a block may use.
int rank_counts_max_dim() {
  return ((232448 - 2048) / (int)sizeof(float) - 2 * TS_FLOATS) / BM / 4 * 4;
}

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok).
// The pivot of row i is its own score at column pivot_cols[i] and is
// written to pivot_out. vals must be zeroed by the caller: label columns
// >= num_valid are never written.
int rank_counts_launch(const float* q, const float* t,
                       const int32_t* pivot_cols, const int32_t* row_ptr,
                       const int32_t* cols, int n, int D, int num_valid,
                       float atol, float rtol, int32_t* greater_out,
                       int32_t* close_out, float* vals_out, float* pivot_out,
                       void* stream) {
  if (n <= 0) return 0;
  const int Dp = (D + 3) & ~3;
  size_t smem = (size_t)(2 * TS_FLOATS + BM * Dp) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      rank_counts_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((n + BM - 1) / BM);
  rank_counts_kernel<<<grid, THREADS, smem, (cudaStream_t)stream>>>(
      q, t, pivot_cols, row_ptr, cols, n, D, num_valid, atol, rtol,
      greater_out, close_out, vals_out, pivot_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
