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
// Design: a register-blocked float32 product on the CUDA cores with the
// counts as its epilogue, in two launches on the caller's stream.
//
//  1. rank_prologue_kernel. One warp per query row computes the pivot
//     pivot_i = q_i . t_{pivot_cols[i]} and zeroes the row's counts; the
//     other blocks zero vals and fill tile_ptr[i][c], the first label of
//     row i at or past column c * BN (c = 0 .. tiles, the last bounded by
//     num_valid), so that a tile's epilogue finds its labels by two loads.
//  2. rank_tiles_kernel. The grid is (row tiles) x (column ranges). A block
//     owns BM = 64 query rows and a range of whole BN-column tiles, which it
//     walks tile by tile; the caller cuts the columns into ranges (of one
//     tile by default: many short blocks, which the card's block scheduler
//     spreads evenly, measured faster than one wave of long ones). A thread holds an 8 x 8 block of accumulators (rows
//     ty + i BM/8, columns tx + 16 j). BK-deep slices of both q and the
//     candidates go through a ring of STAGES buffers in
//     shared memory filled by 16-byte cp.async copies, with one barrier a
//     slice; a slice is stored [row][k] with rows padded to BK + 4 floats,
//     so that the float4 reads along k of 8 neighbouring columns fall into
//     distinct banks and the 16 threads that share a query row read it by
//     broadcast. Four steps of k cost 16 LDS.128 for 256 FMAs. After a
//     tile's last slice the epilogue counts against the pivot, adds the
//     counts of a row over the 16 threads that own it (shuffles) into a
//     shared counter with one writer, and walks the row's labels inside
//     the tile (tile_ptr) to store their scores. At its end the block adds
//     its counts to the outputs with integer atomicAdd: integer addition is
//     exact in any order, so the result does not depend on scheduling or on
//     the number of ranges. vals has one writer per label.
//
// Precision: every score is ONE float32 FMA chain acc = fmaf(q[k], t[k],
// acc) from 0.0f over k ascending (__fmaf_rn, never split over k, no TF32,
// no tensor cores): slices are consumed in ascending k, and k past D is
// zero-filled on both sides, which leaves a chain as it is. A score
// therefore has the same bits wherever it is computed: in a tile, in the
// pivot and in vals. The epilogue runs after the chain at all three places,
// each of its float operations rounded on its own (no --use_fast_math: the
// sqrt is correctly rounded, as torch.sqrt's on the card), so it keeps that
// property. The true column ties with itself exactly, and a caller that
// recounts a label from vals reproduces the kernel's decision. Tensor
// cores are left out for that reason: TF32 and bf16 keep 10 and 7 bits of
// mantissa, and a split product sums in another order than the pivot.
//
// Bound: at evaluation shapes (n = 256, |E| = 14,541, D = 512) the work is
// 2 n |E| D flops against n D + |E| D floats of input, about 60 flops per
// byte, so the card's fp32 CUDA-core rate bounds it, not memory. With
// 64-row blocks the table is read n / 64 times from L2 (once from device
// memory); a build with 128-row blocks measured the same and was dropped.
// Measured on an NVIDIA H100 80GB HBM3 (700 W) at those shapes: about
// 0.135 ms a call against a bound of 0.057 ms (PERF.md has the table); on
// 200,000 candidates the main loop reaches 53% of the fp32 rate.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BN = 128;           // candidate columns per tile
constexpr int BK = 32;            // depth of one staged slice
constexpr int LDS = BK + 4;       // padded row of a slice (floats)
constexpr int STAGES = 3;         // ring of slices in shared memory
constexpr int TX = 16;            // threads across a tile's columns
constexpr int RPT = 8;            // rows per thread
constexpr int CPT = BN / TX;      // columns per thread (8)
constexpr int PROLOGUE_THREADS = 128;
constexpr int PIVOT_ROWS = PROLOGUE_THREADS / 32;  // pivots per block
constexpr int PIVOT_CHUNK = 512;  // floats of a row staged at a time

constexpr int BM = 64;            // query rows per block
constexpr int THREADS = BM * BN / (RPT * CPT);  // 128
constexpr int TY = THREADS / TX;  // threads down a tile's rows (BM / RPT)
constexpr int STAGE_FLOATS = (BM + BN) * LDS;
constexpr int SMEM_BYTES = STAGES * STAGE_FLOATS * (int)sizeof(float);

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

// Score epilogues, by the code the caller passes (ops/rank_kernel.py
// ScoreEpilogue): 0 the identity (the factorizing scorers); 1 neg_sqrt_l2,
// -sqrt(max(-s, 0) + 1e-30), which turns the augmented product -||q - c||^2
// of the L2 distance scorers into -||q - c||. As torch.clamp, the max keeps
// a NaN. Callers pad the augmented operands to a multiple of 4 columns with
// zeros, which leaves the chain as it is and keeps the 16-byte copies.
constexpr int EPILOGUE_NONE = 0;
constexpr int EPILOGUE_NEG_SQRT_L2 = 1;

__device__ __forceinline__ float score_transform(float s, int epilogue) {
  if (epilogue == EPILOGUE_NEG_SQRT_L2) {
    float x = -s;
    x = x < 0.0f ? 0.0f : x;
    return -__fsqrt_rn(__fadd_rn(x, 1e-30f));
  }
  return s;
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

// Blocks [0, pivot_blocks): one warp per query row computes its pivot and
// zeroes its counts. The warp stages the row of q and the pivot's row of t
// in shared memory with coalesced loads, all in flight at once; lane 0 then
// runs the tiles' FMA chain over them in ascending k (a chain has one
// order, so one lane). The other blocks: tile_ptr and zero vals, in a
// grid-stride loop.
__global__ void __launch_bounds__(PROLOGUE_THREADS)
rank_prologue_kernel(const float* __restrict__ q, const float* __restrict__ t,
                     const int32_t* __restrict__ pivot_cols,
                     const int32_t* __restrict__ row_ptr,
                     const int32_t* __restrict__ cols, int n, int D,
                     int num_valid, int num_tiles, int nnz, int pivot_blocks,
                     int epilogue, float* __restrict__ pivot_out,
                     int32_t* __restrict__ greater_out,
                     int32_t* __restrict__ close_out,
                     int32_t* __restrict__ tile_ptr,
                     float* __restrict__ vals_out) {
  if ((int)blockIdx.x < pivot_blocks) {
    __shared__ float s_q[PIVOT_ROWS][PIVOT_CHUNK];
    __shared__ float s_t[PIVOT_ROWS][PIVOT_CHUNK];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * PIVOT_ROWS + warp;
    if (row >= n) return;
    const float* qr = q + (size_t)row * D;
    const float* tr = t + (size_t)pivot_cols[row] * D;
    float p = 0.0f;
    for (int d0 = 0; d0 < D; d0 += PIVOT_CHUNK) {
      const int len = min(PIVOT_CHUNK, D - d0);
      for (int d = lane; d < len; d += 32) {
        s_q[warp][d] = qr[d0 + d];
        s_t[warp][d] = tr[d0 + d];
      }
      __syncwarp();
      if (lane == 0) {
#pragma unroll 8
        for (int d = 0; d < len; ++d)
          p = __fmaf_rn(s_q[warp][d], s_t[warp][d], p);
      }
      __syncwarp();
    }
    if (lane == 0) {
      pivot_out[row] = score_transform(p, epilogue);
      greater_out[row] = 0;
      close_out[row] = 0;
    }
    return;
  }
  const size_t first =
      (size_t)(blockIdx.x - pivot_blocks) * PROLOGUE_THREADS + threadIdx.x;
  const size_t stride = (size_t)(gridDim.x - pivot_blocks) * PROLOGUE_THREADS;
  const int per_row = num_tiles + 1;
  for (size_t e = first; e < (size_t)n * per_row; e += stride) {
    const int row = (int)(e / per_row);
    const int tile = (int)(e - (size_t)row * per_row);
    const long long edge = (long long)tile * BN;
    const int bound = edge < num_valid ? (int)edge : num_valid;
    tile_ptr[e] = lower_bound(cols, row_ptr[row], row_ptr[row + 1], bound);
  }
  for (size_t e = first; e < (size_t)nnz; e += stride) vals_out[e] = 0.0f;
}

// Stage the slice [k0, k0 + BK) of query rows [row0, row0 + BM) and of
// candidate columns [c0, c0 + BN) as st[r * LDS + kk], the query rows first;
// entries past n, num_valid or D are zero-filled.
__device__ __forceinline__ void stage_slice(float* st, const float* q,
                                            const float* t, int row0, int c0,
                                            int k0, int n, int num_valid,
                                            int D, bool vec) {
  if (vec) {
    constexpr int CH = BK / 4;  // 16-byte pieces of a row of the slice
    static_assert((BM + BN) * CH % THREADS == 0, "copies per thread");
#pragma unroll
    for (int u = 0; u < (BM + BN) * CH / THREADS; ++u) {
      const int idx = threadIdx.x + u * THREADS;
      const int r = idx / CH;
      const int kk = (idx - r * CH) * 4;
      const bool is_q = r < BM;
      const int line = is_q ? row0 + r : c0 + r - BM;
      const bool ok = line < (is_q ? n : num_valid) && k0 + kk < D;
      const float* src =
          ok ? (is_q ? q : t) + (size_t)line * D + k0 + kk : q;
      cp_async16(st + r * LDS + kk, src, ok ? 16 : 0);
    }
  } else {
    for (int idx = threadIdx.x; idx < (BM + BN) * BK; idx += THREADS) {
      const int r = idx / BK;
      const int kk = idx - r * BK;
      const bool is_q = r < BM;
      const int line = is_q ? row0 + r : c0 + r - BM;
      const bool ok = line < (is_q ? n : num_valid) && k0 + kk < D;
      const float* src =
          ok ? (is_q ? q : t) + (size_t)line * D + k0 + kk : q;
      cp_async4(st + r * LDS + kk, src, ok ? 4 : 0);
    }
  }
}

// acc[i][j] += sum over the slice's k, ascending, of q[row i][k] t[col j][k]
__device__ __forceinline__ void multiply_slice(float (&acc)[RPT][CPT],
                                               const float* as,
                                               const float* bs, int ty,
                                               int tx) {
#pragma unroll
  for (int kk = 0; kk < BK; kk += 4) {
    float4 a[RPT];
#pragma unroll
    for (int i = 0; i < RPT; ++i)
      a[i] = *reinterpret_cast<const float4*>(as + (ty + TY * i) * LDS + kk);
#pragma unroll
    for (int j = 0; j < CPT; ++j) {
      const float4 b =
          *reinterpret_cast<const float4*>(bs + (tx + TX * j) * LDS + kk);
#pragma unroll
      for (int i = 0; i < RPT; ++i) {
        float c = acc[i][j];
        c = __fmaf_rn(a[i].x, b.x, c);
        c = __fmaf_rn(a[i].y, b.y, c);
        c = __fmaf_rn(a[i].z, b.z, c);
        c = __fmaf_rn(a[i].w, b.w, c);
        acc[i][j] = c;
      }
    }
  }
}

__global__ void __launch_bounds__(THREADS, 2)
rank_tiles_kernel(const float* __restrict__ q, const float* __restrict__ t,
                  const int32_t* __restrict__ cols,
                  const int32_t* __restrict__ tile_ptr,
                  const float* __restrict__ pivot, int n, int D,
                  int num_valid, int num_tiles, int tiles_per_range,
                  float atol, float rtol, int epilogue,
                  int32_t* __restrict__ greater_out,
                  int32_t* __restrict__ close_out,
                  float* __restrict__ vals_out) {
  extern __shared__ __align__(16) float smem[];
  __shared__ float s_piv[BM];
  __shared__ float s_tol[BM];
  __shared__ int s_g[BM];
  __shared__ int s_c[BM];

  const int tid = threadIdx.x;
  const int tx = tid % TX;
  const int ty = tid / TX;
  const int row0 = blockIdx.x * BM;
  const int tile_lo = blockIdx.y * tiles_per_range;
  const int tile_hi = min(tile_lo + tiles_per_range, num_tiles);
  // 16-byte copies need 16-byte aligned rows
  const bool vec = (D & 3) == 0 &&
                   ((reinterpret_cast<uintptr_t>(q) |
                     reinterpret_cast<uintptr_t>(t)) & 15) == 0;
  const int n_ks = max(1, (D + BK - 1) / BK);
  const int total = (tile_hi - tile_lo) * n_ks;

  if (tid < BM) {
    float p = row0 + tid < n ? pivot[row0 + tid] : 0.0f;
    p = isnan(p) ? -INFINITY : p;
    s_piv[tid] = p;
    s_tol[tid] = __fadd_rn(atol, __fmul_rn(rtol, fabsf(p)));
    s_g[tid] = 0;
    s_c[tid] = 0;
  }

  // the next slice to stage: (ld_tile, ld_ks) into ring buffer ld_stage
  int ld_tile = tile_lo, ld_ks = 0, ld_stage = 0;
  auto stage_next = [&]() {
    if (ld_tile < tile_hi) {
      stage_slice(smem + ld_stage * STAGE_FLOATS, q, t, row0,
                      ld_tile * BN, ld_ks * BK, n, num_valid, D, vec);
      if (++ld_ks == n_ks) {
        ld_ks = 0;
        ++ld_tile;
      }
      ld_stage = ld_stage + 1 == STAGES ? 0 : ld_stage + 1;
    }
    cp_async_commit();  // an empty group keeps the count of groups uniform
  };
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) stage_next();

  float acc[RPT][CPT];
#pragma unroll
  for (int i = 0; i < RPT; ++i) {
#pragma unroll
    for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;
  }

  int tile = tile_lo, ks = 0, stage = 0;
  for (int it = 0; it < total; ++it) {
    // slice `it` has landed; every thread is done with slice `it - 1`,
    // whose buffer the next copy refills
    cp_async_wait<STAGES - 2>();
    __syncthreads();
    stage_next();
    const float* as = smem + stage * STAGE_FLOATS;
    multiply_slice(acc, as, as + BM * LDS, ty, tx);
    stage = stage + 1 == STAGES ? 0 : stage + 1;
    if (++ks < n_ks) continue;

    // the tile's scores are complete: counts and label values
    const int c0 = tile * BN;
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
      const int r = ty + TY * i;
      const int row = row0 + r;
      const float p = s_piv[r], tol = s_tol[r];
      int g = 0, c = 0;
#pragma unroll
      for (int j = 0; j < CPT; ++j) {
        acc[i][j] = score_transform(acc[i][j], epilogue);
        int cl, gr;
        close_greater(acc[i][j], p, tol, cl, gr);
        const bool valid = c0 + tx + TX * j < num_valid;
        g += valid ? gr : 0;
        c += valid ? cl : 0;
      }
      if (row < n) {
        const int32_t* tp = tile_ptr + (size_t)row * (num_tiles + 1) + tile;
        const int lo = tp[0], hi = tp[1];
        for (int at = lo; at < hi; ++at) {
          const int cj = cols[at] - c0;
          if ((cj & (TX - 1)) == tx) {
            const int jj = cj / TX;
            float v = 0.0f;
#pragma unroll
            for (int j = 0; j < CPT; ++j) v = j == jj ? acc[i][j] : v;
            vals_out[at] = v;
          }
        }
      }
      // the 16 threads of a row are one half of a warp
#pragma unroll
      for (int off = TX / 2; off > 0; off >>= 1) {
        g += __shfl_xor_sync(0xffffffffu, g, off);
        c += __shfl_xor_sync(0xffffffffu, c, off);
      }
      if (tx == 0) {  // the row's one writer in this block
        s_g[r] += g;
        s_c[r] += c;
      }
#pragma unroll
      for (int j = 0; j < CPT; ++j) acc[i][j] = 0.0f;
    }
    ks = 0;
    ++tile;
  }
  cp_async_wait<0>();
  __syncthreads();
  if (tid < BM && row0 + tid < n) {
    if (s_g[tid]) atomicAdd(greater_out + row0 + tid, s_g[tid]);
    if (s_c[tid]) atomicAdd(close_out + row0 + tid, s_c[tid]);
  }
}

// More than 48 KB of dynamic shared memory has to be allowed per device.
cudaError_t allow_shared_memory() {
  return cudaFuncSetAttribute(rank_tiles_kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              SMEM_BYTES);
}

}  // namespace

extern "C" {

// Candidate columns per tile: the caller plans its column ranges in whole
// tiles of this width.
int rank_counts_tile_cols() { return BN; }

// Query rows per block.
int rank_counts_tile_rows() { return BM; }

// Launches both kernels on `stream`; returns the CUDA error code of the
// first launch that failed (0 = ok). `epilogue` names the score epilogue
// (EPILOGUE_*). The pivot of row i is its own score at column pivot_cols[i]
// and is written to pivot_out. Every output is written
// here, zeros included: greater, close [n], vals [nnz], pivot_out [n].
// tile_ptr: scratch of n * (ceil(num_valid / tile_cols) + 1) int32. The plan:
// the columns cut into ranges of tiles_per_range tiles, one block per (row
// tile, range).
int rank_counts_launch(const float* q, const float* t,
                       const int32_t* pivot_cols, const int32_t* row_ptr,
                       const int32_t* cols, int n, int D, int num_valid,
                       int nnz, float atol, float rtol, int epilogue,
                       int tiles_per_range, int32_t* tile_ptr,
                       int32_t* greater_out, int32_t* close_out,
                       float* vals_out, float* pivot_out, void* stream) {
  if (n <= 0) return 0;
  if (tiles_per_range < 1) return (int)cudaErrorInvalidValue;
  if (epilogue != EPILOGUE_NONE && epilogue != EPILOGUE_NEG_SQRT_L2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int num_tiles = (num_valid + BN - 1) / BN;
  const int pivot_blocks = (n + PIVOT_ROWS - 1) / PIVOT_ROWS;
  const size_t entries = (size_t)n * (num_tiles + 1);
  const size_t fill = entries > (size_t)nnz ? entries : (size_t)nnz;
  size_t fill_blocks = (fill + PROLOGUE_THREADS - 1) / PROLOGUE_THREADS;
  if (fill_blocks > 4096) fill_blocks = 4096;
  rank_prologue_kernel<<<pivot_blocks + (unsigned)fill_blocks,
                         PROLOGUE_THREADS, 0, s>>>(
      q, t, pivot_cols, row_ptr, cols, n, D, num_valid, num_tiles, nnz,
      pivot_blocks, epilogue, pivot_out, greater_out, close_out, tile_ptr,
      vals_out);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_tiles == 0) return (int)err;
  err = allow_shared_memory();
  if (err != cudaSuccess) return (int)err;
  const int ranges = (num_tiles + tiles_per_range - 1) / tiles_per_range;
  if (ranges > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((n + BM - 1) / BM, ranges);
  rank_tiles_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
      q, t, cols, tile_ptr, pivot_out, n, D, num_valid, num_tiles,
      tiles_per_range, atol, rtol, epilogue, greater_out, close_out,
      vals_out);
  return (int)cudaGetLastError();
}

}  // extern "C"
