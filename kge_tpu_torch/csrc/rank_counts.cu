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
// Design of the float32 path: a register-blocked float32 product on the
// CUDA cores with the counts as its epilogue, in two launches on the
// caller's stream (the 16-bit paths below share the first).
//
//  1. rank_prologue_kernel. One warp per query row computes the pivot
//     pivot_i = q_i . t_{pivot_cols[i]} and zeroes the row's counts (for
//     the 16-bit types, further warps write the norm bounds of the
//     certificate); the
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
// acc) from 0.0f over k ascending (__fmaf_rn, never split over k): slices
// are consumed in ascending k, and k past D is zero-filled on both sides,
// which leaves a chain as it is. A score therefore has the same bits
// wherever it is computed: in a tile, in the pivot and in vals. The
// epilogue runs after the chain at all three places, each of its float
// operations rounded on its own (no --use_fast_math: the sqrt is correctly
// rounded, as torch.sqrt's on the card), so it keeps that property. The
// true column ties with itself exactly, and a caller that recounts a label
// from vals reproduces the kernel's decision. The float32 path leaves the
// tensor cores out for that reason: TF32 and bf16 keep 10 and 7 bits of
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
//
// bfloat16 path (rank_counts_launch_bf16; parallel.compute_dtype:
// bfloat16), as kge_tpu's evaluation ranks its bfloat16 score matrix. Its
// outputs are defined by the same float32 chain over the bfloat16 values (a
// product of two bfloat16 values is exact in float32, so each FMA is an
// exact product and one rounded add), each score rounded once to bfloat16,
// and the epilogue and the tie test in bfloat16 with a rounding after every
// operation and the Python constants (1e-30, atol, rtol) rounded to
// bfloat16 first, as JAX computes with weakly typed scalars. vals and the
// pivot are written in bfloat16. The pivot is the prologue's chain, as in
// float32. The chain's 2 n |E| D flops on the CUDA cores cost 0.057 ms at
// the shapes above, twelve times the path's byte bound, so the tiles run on
// the tensor cores instead and the chain is kept for the entries whose
// decision the tensor cores' sum cannot settle:
//
//  1. rank_tiles_tc_kernel. Raw bfloat16 slices of q and of the candidates
//     go through a four-stage cp.async ring (16-, 8- or 4-byte copies by D's
//     alignment, plain loads for odd D; nothing is widened), and four warps
//     multiply the 64 x 128 tile with mma.sync m16n8k16 (bf16 in, float32
//     accumulators) on fragments loaded by ldmatrix (tc_tile_product).
//  2. The certificate. The prologue writes upper bounds N_i >= ||q_i||_2 and
//     M_j >= ||t_j||_2 (sums of squares and the root rounded upward; a
//     bfloat16 row with a subnormal element gets +inf, as the tensor cores
//     may flush one: not measured for bfloat16, whose subnormals lie below
//     1.2e-38). An entry's tensor-core sum x lies within
//       E_ij = RU(gamma_D RU(N_i M_j) + eta_D)
//     of its chain (+inf where N_i M_j > 2^126 or is no number). For every
//     entry the epilogue takes lo = RD(x - E), hi = RU(x + E) and applies
//     the bfloat16 rounding, the epilogue and the tie rule to both. The
//     category (0 below, 1 close, 2 greater) is a non-decreasing function
//     of the chain's float32 value for a finite pivot: R is monotone, so is
//     -R(sqrt(R(max(-R(x), 0) + R(1e-30)))), and the close set
//     {s : |R(s - P)| <= tol} is an interval around P. So where lo and hi
//     fall in one category, the chain does too, and that category is
//     counted. The rest stay undecided: unequal categories, a non-finite
//     lo or hi (so any non-finite x or E), a non-finite pivot or tolerance
//     (there the category is not monotone: with P = +inf a finite score is
//     close and +inf is not).
//  3. The exact path, the prologue's chain (fmaf from 0.0f, k ascending,
//     over the widened bfloat16 values) for every entry the certificate
//     does not settle and every label column. The tile's label columns are
//     listed before its product (tile_ptr, as in the float32 path), and
//     thread j runs the chain of label j over the slices as they pass
//     through the ring, so that vals costs no further reads. The undecided
//     entries are marked in a bitmap in shared memory (one bit an entry,
//     two words a thread: no capacity to overflow). The block reserves as
//     many slots on a worklist with one atomicAdd and writes their (row,
//     column) there, and a third launch (rank_recount_kernel) runs those
//     chains across the whole card, one lane an entry, the rows staged by
//     the warp through shared memory, and adds their categories to the
//     counts. A block whose
//     reservation passes the worklist's capacity marks its slots empty and
//     recounts its entries itself, as it does the labels past the first
//     128, one lane an entry reading global memory. An input with an infinity makes every entry of its row
//     or column undecided and costs only time. Counts stay integer
//     atomicAdds and each vals entry has one writer, so the outputs do not
//     depend on the plan or on scheduling. The number of undecided entries
//     is written to recounted[0].
//
//  The certificate costs a few compares an entry: for a finite pivot the
//  category is 0 below a float32 value cut1, 2 from cut2 on and 1 between;
//  the prologue finds each row's cut1 and cut2 (category_cuts, a search
//  over the ordered float32 values), and the tile kernel compares lo and hi
//  with them.
//
//  Bound and time (PERF.md has the table): at n = 256, |E| = 14,541,
//  D = 512 the path moves about 15 MB of input, 0.0046 ms at the
//  card's memory rate, above its 3.8 GFLOP over the tensor cores' 989
//  TFLOP/s. Measured on an NVIDIA H100 80GB HBM3 (700 W): about 0.068 ms
//  a call, 0.4% of the entries recounted (0.046 ms with the L2 epilogue at
//  D' = 132), against 0.173 ms for the chain on the CUDA cores before. Of
//  the tile launch's 0.045 ms the product takes about 0.022 (mma.sync at
//  some 170 TFLOP/s); the label chains, the certificate, the recount
//  launch (0.011) and the prologue (0.009: the norm pass over the
//  candidates, the pivots and the cut searches) the rest.
//
// gamma_D, the error of x against the chain as a multiple of
// S = sum_k |q_k t_k| <= N_i M_j (Cauchy-Schwarz), with u = 2^-24 and
// D16 = D rounded up to a multiple of 16 (the zero-filled depth):
//  - the chain: D - 1 rounded adds of exact products from 0, so
//    |chain - sum| <= (D - 1) u / (1 - (D - 1) u) S (recursive summation),
//    at most 1.004 D u S for D <= 2^16;
//  - the tensor cores: Hopper's float32 accumulation in mma is not
//    documented as IEEE. Model it as conservatively as its known behaviour
//    allows: products exact, and each hardware step adds b <= 16 products
//    to the accumulator after aligning all b + 1 terms to the largest
//    exponent and truncating (no guard bit), then truncates the normalized
//    result. A step then loses less than (b + 2) 2^-23 of the magnitudes it
//    adds, which are at most S; over D16 / b steps that is at most
//    (b + 2) / b D16 2^-23 S (1 + d) <= 6 D16 u S (1 + d) (b = 1, the
//    worst), d < 8 D16 u <= 1/32 the relative growth of the partial sums.
// The sum, below 7.2 D16 u S for D <= 2^16, is covered by
// gamma_D = D16 2^-21 = 8 D16 u; chip_smoke.py phase 22 checks it on the
// card on the kernel's own sums (rank_counts_tile_sums_bf16) against
// float64 and requires 8 times the largest ratio it sees to stay within
// gamma_D (the model is far from tight: at D = 512 the largest ratio seen
// is about 2^-21, some 300 times below 6 D16 u). A
// larger gamma costs recounts, never a wrong count. eta_D = D16 2^-124
// covers products and partial sums that the tensor cores flush below 2^-126
// (and the chain's own underflow), which a relative bound cannot.
//
// float16 path (rank_counts_launch_f16, rank_pivots_launch_f16;
// parallel.compute_dtype: float16), as kge_tpu's evaluation ranks its
// float16 score matrix. Its outputs are defined as the bfloat16 path's with
// float16 in its place: the float32 chain over the float16 values (a
// product of two float16 values has at most 22 significant bits and lies
// between 2^-48 and 2^32 in magnitude, so it is exact in float32 and each
// FMA is one rounded add), each score rounded once to float16 (R16), and the
// epilogue and the tie test in float16 with a rounding after every
// operation and the Python constants rounded to float16 first
// (Prec<__half>). float16's range is narrow: a score of 65,520 or more in
// magnitude rounds to an infinity, which the tie rule then treats as
// kge_tpu's does (+inf against a +inf pivot is neither close nor greater,
// -inf against -inf is close); the L2 epilogue's 1e-30 rounds to 0, so a
// product at or above 0 scores -0.0; the default atol 1e-5 is a float16
// subnormal. It runs the bfloat16 path's three launches and certificate,
// templated on the element type (T = __half: mma.sync m16n8k16 with f16
// in, ldmatrix as for bfloat16, the same cuts, norms, worklist and chains).
// What carries over, and why:
//  - Monotonicity. For a finite pivot P and tolerance the category is a
//    non-decreasing function of the chain's float32 value c: R16 is
//    monotone, overflow included (c >= 65,520 gives +inf, the largest
//    value, c <= -65,520 gives -inf, the least); the L2 map
//    -R16(sqrt(R16(max(-s, 0) + R16(1e-30)))) is monotone, R16(1e-30) being
//    +0 (every s >= 0 maps to -0.0); the close set {s : |R16(s - P)| <=
//    tol} is an interval around P, since R16(s - P) is monotone in s. tol =
//    R16(R16(atol) + R16(R16(rtol) |P|)) is finite for a finite P, atol's
//    subnormal value included: every rounding here is IEEE's, with
//    subnormal results and no flush to zero (no --use_fast_math). +inf
//    against a finite P is greater and -inf below, the ends of the order. A
//    non-finite pivot or tolerance leaves its row undecided, as in bfloat16.
//  - The norm bounds. How the tensor cores read float16 was measured first
//    (f16_subnormal_check_kernel): every ordered pair of float16 values
//    (2^32) through mma.sync, one product an accumulator, gave the exact
//    float32 product, with neither, one or both operands subnormal: 0
//    differences of 4,294,967,296 on an NVIDIA H100 80GB HBM3 (PERF.md). So
//    norm_bound gives a float16 row with subnormal values no +inf and no
//    widening: each square x^2 >= 2^-48 is a normal float32 and exact, the
//    upward-rounded sum bounds ||x||^2 as it does for any row, and the
//    tensor cores add the exact products q_k t_k that Cauchy-Schwarz bounds
//    by N_i M_j, subnormal factors included.
//  - gamma_D and eta_D. The products are exact and the same hardware
//    accumulates them, so the accumulation model below holds as it does for
//    bfloat16; chip_smoke.py phase 22 checks gamma_D on the kernel's own
//    float16 sums as it does for bfloat16, its wide inputs spread over
//    2^-20..2^12 so that many are subnormal. eta_D is not needed (a nonzero
//    product or partial sum of float16 products is at least 2^-48) and
//    costs nothing.
//  Measured on an NVIDIA H100 80GB HBM3 (700 W) at the shapes above: about
//  0.067 ms a call, 0.33% of the entries recounted (0.046 ms and 0.15% with
//  the L2 epilogue), against 0.148 ms (0.077) for the float32 path's FMA
//  tiles over widened float16 values, which this path replaced; every
//  output equal in bits to theirs (PERF.md). A row whose pivot is infinite
//  is recounted whole, so scores that overflow float16 cost time.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include <type_traits>

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

// The element type's arithmetic: Prec<float> is the float32 path above;
// Prec<__nv_bfloat16> rounds every result to bfloat16 (R), as the
// bfloat16 path's header says.
__device__ __forceinline__ float R(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename T>
struct Prec;

template <>
struct Prec<float> {
  __device__ static float load(const float* p) { return *p; }
  __device__ static void store(float* p, float v) { *p = v; }
  __device__ static float score(float acc, int epilogue) {
    return score_transform(acc, epilogue);
  }
  __device__ static float tol(float atol, float rtol, float p) {
    return __fadd_rn(atol, __fmul_rn(rtol, fabsf(p)));
  }
  __device__ static float diff(float s, float p) { return __fsub_rn(s, p); }
};

template <>
struct Prec<__nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p) {
    return __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, float v) {
    *p = __float2bfloat16_rn(v);  // v is a bfloat16 value already
  }
  __device__ static float score(float acc, int epilogue) {
    const float s = R(acc);
    if (epilogue == EPILOGUE_NEG_SQRT_L2) {
      float x = -s;
      x = x < 0.0f ? 0.0f : x;
      return -R(__fsqrt_rn(R(__fadd_rn(x, R(1e-30f)))));
    }
    return s;
  }
  __device__ static float tol(float atol, float rtol, float p) {
    return R(__fadd_rn(R(atol), R(__fmul_rn(R(rtol), fabsf(p)))));
  }
  __device__ static float diff(float s, float p) { return R(__fsub_rn(s, p)); }
};

// Prec<__half> is the float16 path (header, "float16 path"): R16 rounds every
// result to float16. A float32 result of float16 operands rounded to float16
// is the correctly rounded float16 operation (24 >= 2 x 11 + 2 bits: the
// double rounding is innocuous), as torch and XLA compute float16 on the
// CPU.
__device__ __forceinline__ float R16(float x) {
  return __half2float(__float2half_rn(x));
}

template <>
struct Prec<__half> {
  __device__ static float load(const __half* p) { return __half2float(*p); }
  __device__ static void store(__half* p, float v) {
    *p = __float2half_rn(v);  // v is a float16 value already
  }
  __device__ static float score(float acc, int epilogue) {
    const float s = R16(acc);
    if (epilogue == EPILOGUE_NEG_SQRT_L2) {
      float x = -s;
      x = x < 0.0f ? 0.0f : x;
      return -R16(__fsqrt_rn(R16(__fadd_rn(x, R16(1e-30f)))));
    }
    return s;
  }
  __device__ static float tol(float atol, float rtol, float p) {
    return R16(__fadd_rn(R16(atol), R16(__fmul_rn(R16(rtol), fabsf(p)))));
  }
  __device__ static float diff(float s, float p) { return R16(__fsub_rn(s, p)); }
};

// The tie rule of kge_tpu's _close_greater, with each float operation
// rounded on its own (no contraction into an FMA) as the plain version does;
// the difference in the element type's arithmetic.
template <typename T>
__device__ __forceinline__ void close_greater_as(float s, float p, float tol,
                                                 int& is_close,
                                                 int& is_greater) {
  s = isnan(s) ? -INFINITY : s;
  bool finite = isfinite(s) || isfinite(p);
  bool close = fabsf(Prec<T>::diff(s, p)) <= tol;
  bool both_neg_inf = (s == -INFINITY) && (p == -INFINITY);
  close = both_neg_inf || (close && finite);
  is_close = close ? 1 : 0;
  is_greater = (s > p && !close) ? 1 : 0;
}

// The widened values of a 16-byte load of 8 bfloat16 or float16 values.
template <typename T>
__device__ __forceinline__ void widen8(const uint4& raw, float (&v)[8]) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float2 f;
    if constexpr (std::is_same<T, __half>::value) {
      f = __half22float2(reinterpret_cast<const __half2*>(&raw)[i]);
    } else {
      f = __bfloat1622float2(reinterpret_cast<const __nv_bfloat162*>(&raw)[i]);
    }
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

// An upper bound of ||v||_2 for the bfloat16 or float16 vector v of length
// D, by one warp (every lane returns it): squares summed with upward
// rounding in any order (each partial sum is at least the exact one), the
// root rounded upward. For bfloat16 +inf where v holds a subnormal value,
// which the tensor cores may read as zero; float16 subnormals are read
// exactly (header, "float16 path"). NaN stays NaN. vec8: D % 8 == 0 and v
// 16-byte aligned.
template <typename T>
__device__ __forceinline__ float norm_bound(const T* v, int D, int lane,
                                            bool vec8) {
  constexpr bool kFlagTiny = std::is_same<T, __nv_bfloat16>::value;
  float s = 0.0f;
  bool tiny = false;
  if (vec8) {
    for (int d = lane * 8; d < D; d += 32 * 8) {
      float x[8];
      widen8<T>(*reinterpret_cast<const uint4*>(v + d), x);
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        s = __fmaf_ru(x[i], x[i], s);
        if constexpr (kFlagTiny)
          tiny |= x[i] != 0.0f && fabsf(x[i]) < 1.17549435e-38f;
      }
    }
  } else {
    for (int d = lane; d < D; d += 32) {
      const float x = Prec<T>::load(v + d);
      s = __fmaf_ru(x, x, s);
      if constexpr (kFlagTiny) tiny |= x != 0.0f && fabsf(x) < 1.17549435e-38f;
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    s = __fadd_ru(s, __shfl_xor_sync(0xffffffffu, s, off));
  return __any_sync(0xffffffffu, tiny) ? INFINITY : __fsqrt_ru(s);
}

__device__ __forceinline__ bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

// The ordered keys of the finite float32 values: key(v) < key(w) iff
// v < w (-0 just below +0), from key(-FLT_MAX) = KEY_MIN to key(FLT_MAX) =
// KEY_MAX; key_value inverts it.
constexpr long long KEY_MIN = -0x7f7fffffLL - 1, KEY_MAX = 0x7f7fffffLL;

__device__ __forceinline__ float key_value(long long k) {
  return __int_as_float(k >= 0 ? (int)k : (int)(0x80000000u | (unsigned)(-k - 1)));
}

// For the 16-bit paths: the row's category cuts, cut1 and cut2, the least
// finite float32 values c whose category under the tie rule (0 below the
// pivot p, 1 close, 2 greater; the chain's value c rounded to T and mapped
// by the epilogue) is at least 1 and 2, +inf where there is none.
// The category is non-decreasing in c for a finite p and tolerance
// (header, "The certificate"), so the first key at which it reaches a
// level is found by a 16-ary search: one warp, lanes 0-15 for cut1 and
// 16-31 for cut2, 16 probes a round, eight rounds over the 2^32 keys.
template <typename T>
__device__ void category_cuts(float p, float tol, int epilogue, int lane,
                              float& cut1, float& cut2) {
  const int half = lane >> 4, probe = lane & 15, level = half + 1;
  long long lo = KEY_MIN, hi = KEY_MAX + 1;  // hi = KEY_MAX + 1: none
  // the answer lies in [lo, hi]; every key below lo is below `level`
  while (__any_sync(0xffffffffu, lo < hi)) {
    const bool active = lo < hi;
    const long long step = active ? (hi - lo + 15) / 16 : 1;
    const long long k = lo + step * probe;
    bool at_least = true;
    if (active && k < hi) {
      int cl, gr;
      close_greater_as<T>(Prec<T>::score(key_value(k), epilogue), p, tol, cl,
                          gr);
      at_least = cl + 2 * gr >= level;
    }
    const unsigned votes =
        (__ballot_sync(0xffffffffu, at_least) >> (16 * half)) & 0xffffu;
    if (active) {
      if (votes == 0) {
        lo += 15 * step + 1;
      } else {
        const int first = __ffs(votes) - 1;
        hi = min(hi, lo + step * first);
        if (first > 0) lo += step * (first - 1) + 1;
      }
    }
  }
  const float cut = hi > KEY_MAX ? INFINITY : key_value(hi);
  cut1 = __shfl_sync(0xffffffffu, cut, 0);
  cut2 = __shfl_sync(0xffffffffu, cut, 16);
}

// Blocks [0, pivot_blocks): one warp per query row computes its pivot and
// zeroes its counts (greater_out non-null). The warp stages the row of q
// and the pivot's row of t, t[pivot_cols[row] - col_lo], in shared memory
// with coalesced loads, all in flight at once; lane 0 then runs the tiles'
// FMA chain over them in ascending k (a chain has one order, so one lane).
// A pivot column outside [0, num_valid) after the shift gives -0.0, the
// neutral element of a sum: the columns of a row-sharded table (col_lo the
// shard's first row) leave the pivot to the rank that holds it. With
// pivot_in the pivot is given, as the scores' own values, and no chain
// runs. For the 16-bit types with norms the warp then writes the row's
// category cuts (category_cuts) to norms[n + num_valid + 2 row + {0, 1}].
// Then, for the 16-bit types only, norm_blocks blocks: one warp per vector writes
// norm_bound of the rows of q to norms[0, n) and of the candidates to
// norms[n, n + num_valid), and the first zeroes recounted[0, 2). The other blocks: tile_ptr and zero vals, in a grid-stride
// loop.
template <typename T>
__global__ void __launch_bounds__(PROLOGUE_THREADS)
rank_prologue_kernel(const T* __restrict__ q, const T* __restrict__ t,
                     const int32_t* __restrict__ pivot_cols,
                     const T* __restrict__ pivot_in, int col_lo,
                     const int32_t* __restrict__ row_ptr,
                     const int32_t* __restrict__ cols, int n, int D,
                     int num_valid, int num_tiles, int nnz, int pivot_blocks,
                     int norm_blocks, int epilogue, float atol, float rtol,
                     T* __restrict__ pivot_out,
                     int32_t* __restrict__ greater_out,
                     int32_t* __restrict__ close_out,
                     int32_t* __restrict__ tile_ptr,
                     T* __restrict__ vals_out, float* __restrict__ norms,
                     unsigned long long* __restrict__ recounted) {
  if ((int)blockIdx.x < pivot_blocks) {
    __shared__ float s_q[PIVOT_ROWS][PIVOT_CHUNK];
    __shared__ float s_t[PIVOT_ROWS][PIVOT_CHUNK];
    const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
    const int row = blockIdx.x * PIVOT_ROWS + warp;
    if (row >= n) return;
    float score;
    if (pivot_in != nullptr) {
      score = Prec<T>::load(pivot_in + row);
    } else {
      const int col = pivot_cols[row] - col_lo;
      const bool held = col >= 0 && col < num_valid;
      const T* qr = q + (size_t)row * D;
      const T* tr = t + (size_t)(held ? col : 0) * D;
      float p = 0.0f;
      for (int d0 = 0; held && d0 < D; d0 += PIVOT_CHUNK) {
        const int len = min(PIVOT_CHUNK, D - d0);
        for (int d = lane; d < len; d += 32) {
          s_q[warp][d] = Prec<T>::load(qr + d0 + d);
          s_t[warp][d] = Prec<T>::load(tr + d0 + d);
        }
        __syncwarp();
        if (lane == 0) {
#pragma unroll 8
          for (int d = 0; d < len; ++d)
            p = __fmaf_rn(s_q[warp][d], s_t[warp][d], p);
        }
        __syncwarp();
      }
      score = __shfl_sync(0xffffffffu,
                          held ? Prec<T>::score(p, epilogue) : -0.0f, 0);
    }
    if (lane == 0) {
      Prec<T>::store(pivot_out + row, score);
      if (greater_out != nullptr) {
        greater_out[row] = 0;
        close_out[row] = 0;
      }
    }
    if constexpr (!std::is_same<T, float>::value) {
      if (norms == nullptr) return;
      // the row's category cuts for the certificate, after its norm bounds
      float s = score;
      s = isnan(s) ? -INFINITY : s;
      const float tol = Prec<T>::tol(atol, rtol, s);
      float cut1 = NAN, cut2 = NAN;
      if (isfinite(s) && isfinite(tol))
        category_cuts<T>(s, tol, epilogue, lane, cut1, cut2);
      if (lane == 0) {
        norms[n + num_valid + 2 * row] = cut1;
        norms[n + num_valid + 2 * row + 1] = cut2;
      }
    }
    return;
  }
  if constexpr (!std::is_same<T, float>::value) {
    if ((int)blockIdx.x < pivot_blocks + norm_blocks) {
      const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
      if ((int)blockIdx.x == pivot_blocks && threadIdx.x < 2)
        recounted[threadIdx.x] = 0;
      const int v = (blockIdx.x - pivot_blocks) * PIVOT_ROWS + warp;
      if (v >= n + num_valid) return;
      const bool vec8 = (D & 7) == 0 && aligned16(q) && aligned16(t);
      const T* src = v < n ? q + (size_t)v * D : t + (size_t)(v - n) * D;
      const float bound = norm_bound<T>(src, D, lane, vec8);
      if (lane == 0) norms[v] = bound;
      return;
    }
  }
  const int lead = pivot_blocks + norm_blocks;
  const size_t first =
      (size_t)(blockIdx.x - lead) * PROLOGUE_THREADS + threadIdx.x;
  const size_t stride = (size_t)(gridDim.x - lead) * PROLOGUE_THREADS;
  const int per_row = num_tiles + 1;
  for (size_t e = first; e < (size_t)n * per_row; e += stride) {
    const int row = (int)(e / per_row);
    const int tile = (int)(e - (size_t)row * per_row);
    const long long edge = (long long)tile * BN;
    const int bound = edge < num_valid ? (int)edge : num_valid;
    tile_ptr[e] = lower_bound(cols, row_ptr[row], row_ptr[row + 1], bound);
  }
  for (size_t e = first; e < (size_t)nnz; e += stride)
    Prec<T>::store(vals_out + e, 0.0f);
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
    s_tol[tid] = Prec<float>::tol(atol, rtol, p);
    s_g[tid] = 0;
    s_c[tid] = 0;
  }

  // the next slice to stage: (ld_tile, ld_ks) into ring buffer ld_stage
  int ld_tile = tile_lo, ld_ks = 0, ld_stage = 0;
  auto stage_next = [&]() {
    if (ld_tile < tile_hi) {
      stage_slice(smem + ld_stage * STAGE_FLOATS, q, t, row0, ld_tile * BN,
                  ld_ks * BK, n, num_valid, D, vec);
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
        close_greater_as<float>(acc[i][j], p, tol, cl, gr);
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

// -- the 16-bit paths on the tensor cores (header, "bfloat16 path" and
// "float16 path"), T = __nv_bfloat16 or __half ------------------------------

using bf16 = __nv_bfloat16;

template <typename T>
__device__ __forceinline__ T zero16();
template <>
__device__ __forceinline__ __nv_bfloat16 zero16<__nv_bfloat16>() {
  return __ushort_as_bfloat16(0);
}
template <>
__device__ __forceinline__ __half zero16<__half>() {
  return __ushort_as_half(0);
}

constexpr int TC_BK = 32;              // depth of one staged slice (2 x k16)
constexpr int TC_LDS = TC_BK + 8;      // padded row of a slice (16-bit): 80 bytes,
                                       // so ldmatrix's 8 rows hit distinct banks
constexpr int TC_STAGES = 4;           // ring of slices in shared memory
constexpr int TC_THREADS = 128;        // four warps, 2 x 2 over the tile
constexpr int TC_WM = BM / 2;          // a warp's rows (32)
constexpr int TC_WN = BN / 2;          // a warp's columns (64)
constexpr int TC_MI = TC_WM / 16;      // m16 fragments a warp (2)
constexpr int TC_NI = TC_WN / 8;       // n8 fragments a warp (8)
constexpr int TC_STAGE_ELEMS = (BM + BN) * TC_LDS;
constexpr int TC_SMEM_BYTES = TC_STAGES * TC_STAGE_ELEMS * (int)sizeof(bf16);
constexpr int TC_WORDS = BM * BN / 32;  // the tile's bitmap of undecided entries
static_assert(TC_WORDS == 2 * TC_THREADS, "two bitmap words a thread");

// cp.async of BYTES (4, 8 or 16) from global to shared memory; src_bytes 0
// zero-fills.
template <int BYTES>
__device__ __forceinline__ void cp_async_bytes(void* dst, const void* src,
                                               int src_bytes) {
  unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if constexpr (BYTES == 16) {
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d),
                 "l"(src), "r"(src_bytes));
  } else {
    asm volatile("cp.async.ca.shared.global [%0], [%1], %2, %3;\n" ::"r"(d),
                 "l"(src), "n"(BYTES), "r"(src_bytes));
  }
}

// Stage the slice [k0, k0 + TC_BK) of query rows [row0, row0 + BM) and of
// candidate columns [c0, c0 + BN) as raw 16-bit values, st[r * TC_LDS + kk], the
// query rows first; entries past n, num_valid or D are zero-filled. VEC
// elements a copy: 8, 4, 2 by cp.async (D a multiple of VEC, rows aligned),
// 1 by plain loads and stores (odd D).
template <typename T, int VEC>
__device__ __forceinline__ void tc_stage(T* st, const T* q, const T* t,
                                         int row0, int c0, int k0, int n,
                                         int num_valid, int D) {
  constexpr int CH = TC_BK / VEC;  // pieces of a row of the slice
  constexpr int PIECES = (BM + BN) * CH;
  static_assert(PIECES % TC_THREADS == 0, "copies per thread");
#pragma unroll 8
  for (int u = 0; u < PIECES / TC_THREADS; ++u) {
    const int idx = threadIdx.x + u * TC_THREADS;
    const int r = idx / CH;
    const int kk = (idx - r * CH) * VEC;
    const bool is_q = r < BM;
    const int line = is_q ? row0 + r : c0 + r - BM;
    const bool ok = line < (is_q ? n : num_valid) && k0 + kk < D;
    const T* src = ok ? (is_q ? q : t) + (size_t)line * D + k0 + kk : q;
    if constexpr (VEC == 1) {
      st[r * TC_LDS + kk] = ok ? *src : zero16<T>();
    } else {
      cp_async_bytes<2 * VEC>(st + r * TC_LDS + kk, src, ok ? 2 * VEC : 0);
    }
  }
}

__device__ __forceinline__ void ldmatrix_x4(unsigned (&r)[4], const void* p) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(p);
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(a));
}

// c += a b for one m16n8k16 fragment: bfloat16 in, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&c)[4], const unsigned (&a)[4],
                                         unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// the same with float16 in
__device__ __forceinline__ void mma_f16(float (&c)[4], const unsigned (&a)[4],
                                        unsigned b0, unsigned b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.f16.f16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

template <typename T>
__device__ __forceinline__ void mma16(float (&c)[4], const unsigned (&a)[4],
                                      unsigned b0, unsigned b1) {
  if constexpr (std::is_same<T, __half>::value) {
    mma_f16(c, a, b0, b1);
  } else {
    mma_bf16(c, a, b0, b1);
  }
}

// The tensor cores' sums of the 64 x 128 tile at (row0, c0) over all of D:
// warp w holds rows (w / 2) 32 + [0, 32) and columns (w % 2) 64 + [0, 64);
// acc[mi][ni][e] is row (w / 2) 32 + mi 16 + lane / 4 + (e / 2) 8, column
// (w % 2) 64 + ni 8 + (lane % 4) 2 + e % 2 (the mma accumulator layout).
// Runs the ring from empty to empty: it ends with the ring drained and a
// barrier. The tile kernel and rank_counts_tile_sums_as both call it.
// With lr >= 0 the thread also runs the chain of the tile's entry (lr, lc)
// (a label column) over the staged slices, k ascending up to D, into chain.
template <typename T, int VEC>
__device__ __forceinline__ void tc_tile_product(
    float (&acc)[TC_MI][TC_NI][4], T* smem, const T* q, const T* t, int row0,
    int c0, int n, int num_valid, int D, int lr, int lc, float& chain) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
#pragma unroll
  for (int mi = 0; mi < TC_MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < TC_NI; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.0f;
    }
  }
  const int n_ks = max(1, (D + TC_BK - 1) / TC_BK);
#pragma unroll
  for (int s = 0; s < TC_STAGES - 1; ++s) {
    if (s < n_ks)
      tc_stage<T, VEC>(smem + s * TC_STAGE_ELEMS, q, t, row0, c0, s * TC_BK, n,
                       num_valid, D);
    cp_async_commit();  // an empty group keeps the count of groups uniform
  }
  // lane addresses of the ldmatrix loads: A (rows lane % 16, k + 8 for the
  // upper half-warp), B (two n8 fragments of 16 rows, k + 8 for lanes 8-15
  // and 24-31)
  const int a_row = wm * TC_WM + (lane & 15), a_k = (lane >> 4) * 8;
  const int b_row = BM + wn * TC_WN + ((lane >> 4) << 3) + (lane & 7);
  const int b_k = ((lane >> 3) & 1) * 8;
  for (int ks = 0; ks < n_ks; ++ks) {
    // slice ks has landed; every thread is done with slice ks - 1, whose
    // buffer the next copy refills
    cp_async_wait<TC_STAGES - 2>();
    __syncthreads();
    const int next = ks + TC_STAGES - 1;
    if (next < n_ks)
      tc_stage<T, VEC>(smem + (next % TC_STAGES) * TC_STAGE_ELEMS, q, t, row0,
                       c0, next * TC_BK, n, num_valid, D);
    cp_async_commit();
    const T* st = smem + (ks % TC_STAGES) * TC_STAGE_ELEMS;
#pragma unroll
    for (int kk = 0; kk < TC_BK; kk += 16) {
      unsigned a[TC_MI][4], b[TC_NI][2];
#pragma unroll
      for (int mi = 0; mi < TC_MI; ++mi)
        ldmatrix_x4(a[mi], st + (a_row + mi * 16) * TC_LDS + kk + a_k);
#pragma unroll
      for (int nj = 0; nj < TC_NI / 2; ++nj) {
        unsigned r[4];
        ldmatrix_x4(r, st + (b_row + nj * 16) * TC_LDS + kk + b_k);
        b[2 * nj][0] = r[0];
        b[2 * nj][1] = r[1];
        b[2 * nj + 1][0] = r[2];
        b[2 * nj + 1][1] = r[3];
      }
#pragma unroll
      for (int mi = 0; mi < TC_MI; ++mi) {
#pragma unroll
        for (int ni = 0; ni < TC_NI; ++ni)
          mma16<T>(acc[mi][ni], a[mi], b[ni][0], b[ni][1]);
      }
    }
    if (lr >= 0) {
      const T* ra = st + lr * TC_LDS;
      const T* rb = st + (BM + lc) * TC_LDS;
      const int len = min(TC_BK, D - ks * TC_BK);
      if (len == TC_BK) {
#pragma unroll
        for (int kk = 0; kk < TC_BK; kk += 8) {
          float x[8], y[8];
          widen8<T>(*reinterpret_cast<const uint4*>(ra + kk), x);
          widen8<T>(*reinterpret_cast<const uint4*>(rb + kk), y);
#pragma unroll
          for (int i = 0; i < 8; ++i) chain = __fmaf_rn(x[i], y[i], chain);
        }
      } else {
        for (int kk = 0; kk < len; ++kk)
          chain = __fmaf_rn(Prec<T>::load(ra + kk), Prec<T>::load(rb + kk), chain);
      }
    }
  }
  cp_async_wait<0>();
  __syncthreads();
}

// The certificate of one entry with tensor-core sum x (header, "The
// certificate"): open = 1 when it leaves the chain's category undecided,
// else greater and close give the category (0 below the pivot, 1 close, 2
// greater). nq, nt: the norm bounds of the row and the column; cut1, cut2:
// the row's least float32 values of category 1 and 2 (category_cuts), so
// that the category of v is 0 below cut1, 2 from cut2 on and 1 between;
// ok_row: the pivot and its tolerance are finite. Branch-free.
__device__ __forceinline__ void certify(float x, float nq, float nt,
                                        float gamma, float eta, float cut1,
                                        float cut2, bool ok_row, int& open,
                                        int& greater, int& close) {
  const float nm = __fmul_ru(nq, nt);
  const float e = nm <= 0x1p126f ? __fmaf_ru(gamma, nm, eta) : INFINITY;
  const float lo = __fsub_rd(x, e), hi = __fadd_ru(x, e);
  const bool ok = ok_row && fabsf(lo) <= 3.40282347e38f &&
                  fabsf(hi) <= 3.40282347e38f;
  const bool above = lo >= cut2, between = lo >= cut1 && hi < cut2;
  const bool decided = ok && (hi < cut1 || above || between);
  open = decided ? 0 : 1;
  greater = decided && above ? 1 : 0;
  close = decided && between ? 1 : 0;
}

// The prologue's chain for one entry: fmaf from 0.0f over k ascending of
// the widened 16-bit values, read from global memory (the tile kernel's
// rare in-block path: a full worklist, labels past the first 128).
template <typename T>
__device__ __forceinline__ float exact_chain(const T* a, const T* b, int D) {
  float acc = 0.0f;
  for (int d = 0; d < D; ++d)
    acc = __fmaf_rn(Prec<T>::load(a + d), Prec<T>::load(b + d), acc);
  return acc;
}

// The exclusive prefix sum over the block of v (one value a thread);
// returns the total. warp_sums: shared, one int a warp. Ends with a
// barrier.
__device__ __forceinline__ int block_scan(int& v, int* warp_sums) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int inclusive = v;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, inclusive, off);
    if (lane >= off) inclusive += y;
  }
  if (lane == 31) warp_sums[warp] = inclusive;
  __syncthreads();
  int before = 0, total = 0;
  for (int w = 0; w < TC_THREADS / 32; ++w) {
    before += w < warp ? warp_sums[w] : 0;
    total += warp_sums[w];
  }
  v = before + inclusive - v;
  __syncthreads();
  return total;
}

// The bitmap of a tile's undecided entries: thread `tid` owns words 2 tid
// and 2 tid + 1, and its entry acc[mi][ni][2 h + e] is bit open_bit(mi, h,
// ni, e) of that pair; open_entry maps a (word, bit) back to the entry's
// row and column in the tile.
__device__ __forceinline__ int open_bit(int mi, int h, int ni, int e) {
  return ((mi * 2 + h) * TC_NI + ni) * 2 + e;
}

__device__ __forceinline__ void open_entry(int word, int bit, int& r,
                                           int& col) {
  const int tid = word >> 1, b = (word & 1) * 32 + bit;
  const int lane = tid & 31, warp = tid >> 5;
  const int e = b & 1, ni = (b >> 1) % TC_NI, h = (b / (2 * TC_NI)) & 1;
  const int mi = b / (4 * TC_NI);
  r = (warp >> 1) * TC_WM + mi * 16 + h * 8 + (lane >> 2);
  col = (warp & 1) * TC_WN + ni * 8 + (lane & 3) * 2 + e;
}

// The row of label j of a tile: the last row r with lab_at[r] <= j
// (lab_at: the rows' first label items, non-decreasing, lab_at[0] = 0).
__device__ __forceinline__ int label_row(const int* lab_at, int j) {
  int lo = 0, hi = BM - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (lab_at[mid] <= j) lo = mid; else hi = mid - 1;
  }
  return lo;
}

// The 16-bit tile kernel: the grid and the column ranges of the float32
// kernel (rank_plan), the tile product on the tensor cores, then per tile
// the certificate over every entry and the exact path over the undecided
// entries and the label columns.
template <typename T, int VEC>
__global__ void __launch_bounds__(TC_THREADS, 2)
rank_tiles_tc_kernel(const T* __restrict__ q, const T* __restrict__ t,
                     const int32_t* __restrict__ cols,
                     const int32_t* __restrict__ tile_ptr,
                     const T* __restrict__ pivot,
                     const float* __restrict__ norms, int n, int D,
                     int num_valid, int num_tiles, int tiles_per_range,
                     float atol, float rtol, int epilogue,
                     int32_t* __restrict__ greater_out,
                     int32_t* __restrict__ close_out,
                     T* __restrict__ vals_out,
                     int32_t* __restrict__ work, int work_capacity,
                     unsigned long long* __restrict__ recounted) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* smem = reinterpret_cast<T*>(tc_smem);
  __shared__ float s_piv[BM], s_tol[BM], s_nq[BM], s_nt[BN];
  __shared__ long long s_base;
  __shared__ float s_cut1[BM], s_cut2[BM];
  __shared__ int s_g[BM], s_c[BM];
  __shared__ unsigned s_open[TC_WORDS];  // undecided entries (open_bit)
  __shared__ int s_open_at[TC_THREADS];  // first item of words 2 i, 2 i + 1
  __shared__ int s_lab_at[BM + 1];       // first label item of each row
  __shared__ int s_lab_first[BM];        // the row's first label in the tile
  __shared__ int s_warp[TC_THREADS / 32];
  __shared__ int s_undecided;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.x * BM;
  const int tile_lo = blockIdx.y * tiles_per_range;
  const int tile_hi = min(tile_lo + tiles_per_range, num_tiles);
  const int d16 = (D + 15) / 16 * 16;
  const float gamma = (float)d16 * 0x1p-21f, eta = (float)d16 * 0x1p-124f;

  if (tid < BM) {
    const bool in = row0 + tid < n;
    float p = in ? Prec<T>::load(pivot + row0 + tid) : 0.0f;
    p = isnan(p) ? -INFINITY : p;
    s_piv[tid] = p;
    s_tol[tid] = Prec<T>::tol(atol, rtol, p);
    s_nq[tid] = in ? norms[row0 + tid] : 0.0f;
    const float* cuts = norms + n + num_valid + 2 * (row0 + tid);
    s_cut1[tid] = in ? cuts[0] : 0.0f;
    s_cut2[tid] = in ? cuts[1] : 0.0f;
    s_g[tid] = 0;
    s_c[tid] = 0;
  }
  if (tid == 0) s_undecided = 0;

  for (int tile = tile_lo; tile < tile_hi; ++tile) {
    const int c0 = tile * BN;
    // the tile's labels: label j (in row order) is at s_lab_first[r] + j -
    // s_lab_at[r] for the last row r with s_lab_at[r] <= j. Thread j <
    // TC_THREADS runs the chain of label j inside the product, from the
    // staged slices; the exact path takes the rest.
    int labels = 0, first = 0;
    if (tid < BM && row0 + tid < n) {
      const int32_t* tp =
          tile_ptr + (size_t)(row0 + tid) * (num_tiles + 1) + tile;
      first = tp[0];
      labels = tp[1] - first;
    }
    const int n_lab = block_scan(labels, s_warp);
    if (tid < BM) {
      s_lab_at[tid] = labels;
      s_lab_first[tid] = first;
    }
    if (tid == 0) s_lab_at[BM] = n_lab;
    __syncthreads();
    int lr = -1, lc = 0, lat = 0;
    if (tid < n_lab) {
      lr = label_row(s_lab_at, tid);
      lat = s_lab_first[lr] + tid - s_lab_at[lr];
      lc = cols[lat] - c0;
    }
    float acc[TC_MI][TC_NI][4], chain = 0.0f;
    tc_tile_product<T, VEC>(acc, smem, q, t, row0, c0, n, num_valid, D, lr, lc,
                            chain);
    if (lr >= 0) Prec<T>::store(vals_out + lat, Prec<T>::score(chain, epilogue));

    if (tid < BN)
      s_nt[tid] = c0 + tid < num_valid ? norms[n + c0 + tid] : 0.0f;
    __syncthreads();

    // the certificate over the thread's 64 entries; the undecided ones go
    // to the bitmap, two words a thread: bit open_bit(mi, h, ni, e) of
    // s_open[2 tid], s_open[2 tid + 1] (open_entry maps it back)
    unsigned open_lo = 0, open_hi = 0;
    int undecided = 0;
#pragma unroll
    for (int mi = 0; mi < TC_MI; ++mi) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int r = wm * TC_WM + mi * 16 + h * 8 + (lane >> 2);
        const float nq = s_nq[r], cut1 = s_cut1[r], cut2 = s_cut2[r];
        const bool row_in = row0 + r < n;
        const bool ok_row = isfinite(s_piv[r]) && isfinite(s_tol[r]);
        int g = 0, c = 0;
#pragma unroll
        for (int ni = 0; ni < TC_NI; ++ni) {
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = wn * TC_WN + ni * 8 + (lane & 3) * 2 + e;
            int open, gr, cl;
            certify(acc[mi][ni][2 * h + e], nq, s_nt[col], gamma, eta, cut1,
                    cut2, ok_row, open, gr, cl);
            const bool valid = row_in && c0 + col < num_valid;
            open = valid ? open : 0;
            const int bit = open_bit(mi, h, ni, e);
            if (bit < 32) open_lo |= (unsigned)open << bit;
            else open_hi |= (unsigned)open << (bit - 32);
            undecided += open;
            g += valid ? gr : 0;
            c += valid ? cl : 0;
          }
        }
        // the four lanes of a row are a quad
        g += __shfl_xor_sync(0xffffffffu, g, 1);
        c += __shfl_xor_sync(0xffffffffu, c, 1);
        g += __shfl_xor_sync(0xffffffffu, g, 2);
        c += __shfl_xor_sync(0xffffffffu, c, 2);
        if ((lane & 3) == 0) {
          if (g) atomicAdd(&s_g[r], g);
          if (c) atomicAdd(&s_c[r], c);
        }
      }
    }
    s_open[2 * tid] = open_lo;
    s_open[2 * tid + 1] = open_hi;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      undecided += __shfl_xor_sync(0xffffffffu, undecided, off);
    if (lane == 0 && undecided) atomicAdd(&s_undecided, undecided);
    __syncthreads();

    // the exact path's items: the undecided entries, then the labels past
    // the first TC_THREADS
    int bits_here = __popc(s_open[2 * tid]) + __popc(s_open[2 * tid + 1]);
    const int n_open = block_scan(bits_here, s_warp);
    s_open_at[tid] = bits_here;
    __syncthreads();
    // the undecided entries go to the worklist of the recount launch when
    // all of them fit; a block whose reservation passes the capacity marks
    // the reserved slots below it empty (row -1) and recounts its entries
    // itself
    if (tid == 0)
      s_base = n_open > 0
                   ? (long long)atomicAdd(recounted + 1,
                                          (unsigned long long)n_open)
                   : 0;
    __syncthreads();
    long long base = s_base;
    if (base + n_open > work_capacity) {
      for (long long i = base + tid; i < work_capacity; i += TC_THREADS)
        work[2 * i] = -1;
      base = -1;
    }
    const int items = n_open + max(0, n_lab - TC_THREADS);
    // item i to lane i / 4 of warp i % 4: the four warps share the few
    // items of a tile, each warp's loads touching fewer rows at once
    for (int i = lane * 4 + warp; i < items; i += TC_THREADS) {
      int r, col, at = -1;
      if (i < n_open) {
        int lo = 0, hi = TC_THREADS - 1;  // the last slot starting at or before i
        while (lo < hi) {
          const int mid = (lo + hi + 1) >> 1;
          if (s_open_at[mid] <= i) lo = mid; else hi = mid - 1;
        }
        int k = i - s_open_at[lo], word = 2 * lo;
        unsigned w = s_open[word];
        if (k >= __popc(w)) {
          k -= __popc(w);
          w = s_open[++word];
        }
        for (; k > 0; --k) w &= w - 1;  // the k-th set bit
        open_entry(word, __ffs(w) - 1, r, col);
        if (base >= 0) {
          work[2 * (base + i)] = row0 + r;
          work[2 * (base + i) + 1] = c0 + col;
          continue;
        }
      } else {
        const int j = i - n_open + TC_THREADS;
        r = label_row(s_lab_at, j);
        at = s_lab_first[r] + j - s_lab_at[r];
        col = cols[at] - c0;
      }
      const float s = Prec<T>::score(
          exact_chain<T>(q + (size_t)(row0 + r) * D, t + (size_t)(c0 + col) * D,
                         D),
          epilogue);
      if (at < 0) {
        int cl, gr;
        close_greater_as<T>(s, s_piv[r], s_tol[r], cl, gr);
        if (gr) atomicAdd(&s_g[r], 1);
        if (cl) atomicAdd(&s_c[r], 1);
      } else {
        Prec<T>::store(vals_out + at, s);
      }
    }
    // the next tile's product begins with a barrier before s_open and s_nt
    // are written again
  }
  __syncthreads();
  if (tid < BM && row0 + tid < n) {
    if (s_g[tid]) atomicAdd(greater_out + row0 + tid, s_g[tid]);
    if (s_c[tid]) atomicAdd(close_out + row0 + tid, s_c[tid]);
  }
  if (tid == 0 && s_undecided)
    atomicAdd(recounted, (unsigned long long)s_undecided);
}

// The recount launch: the chain of every entry on the worklist (row, col
// pairs in the first min(recounted[1], work_capacity) slots; row -1 marks
// an empty slot), its category added to the row's counts. A warp takes 32
// entries, one a lane; the entries' rows pass through a ring of RC_STAGES
// chunks of RC_K values per warp in shared memory, copied by the whole warp
// with cp.async (VEC values a copy, 128-byte lines shared by 8 lanes), and
// each lane runs its chain over its own rows, k ascending up to D.
constexpr int RC_K = 64;                 // values of a row per chunk
constexpr int RC_STAGES = 4;             // chunks of a warp in flight
constexpr int RC_LD = RC_K + 8;          // a row of a chunk (16-bit): 144 bytes
constexpr int RC_ES = 2 * RC_LD + 8;     // an entry's two rows, padded to 304
                                         // bytes: 8 lanes' reads hit distinct banks
constexpr int RC_CHUNK = 32 * RC_ES;     // one chunk of a warp (16-bit)
constexpr int RC_SMEM_BYTES =
    (TC_THREADS / 32) * RC_STAGES * RC_CHUNK * (int)sizeof(bf16);

// The copies of one chunk: slot u of a lane is piece idx = lane + 32 u of
// the warp's 32 x 2 x RC_K / VEC pieces (entry idx / (2 P), side 0 for the
// query row and 1 for the candidate's, values kk of the chunk). For VEC >=
// 4 the rows of a lane's slots are looked up once per round (rc_lines);
// for smaller pieces they come by shuffles at every chunk.
template <int VEC>
__host__ __device__ constexpr int rc_slots() { return 2 * (RC_K / VEC); }

template <int VEC>
__device__ __forceinline__ int rc_line(int my_row, int my_col, int u,
                                       int lane) {
  constexpr int P = RC_K / VEC;
  const int idx = lane + 32 * u, e = idx / (2 * P);
  const int row_e = __shfl_sync(0xffffffffu, my_row, e);
  const int col_e = __shfl_sync(0xffffffffu, my_col, e);
  return (idx % (2 * P)) / P ? col_e : row_e;
}

template <typename T, int VEC>
__device__ __forceinline__ void rc_copy(T* buf, const T* q, const T* t,
                                        int line, int u, int k0, int D,
                                        int lane) {
  constexpr int P = RC_K / VEC;
  const int idx = lane + 32 * u, e = idx / (2 * P), rest = idx % (2 * P);
  const int side = rest / P, kk = (rest % P) * VEC;
  const bool ok = line >= 0 && k0 + kk < D;
  const T* src = ok ? (side ? t : q) + (size_t)line * D + k0 + kk : q;
  T* dst = buf + e * RC_ES + side * RC_LD + kk;
  if constexpr (VEC == 1) {
    *dst = ok ? *src : zero16<T>();
  } else {
    cp_async_bytes<2 * VEC>(dst, src, ok ? 2 * VEC : 0);
  }
}

template <typename T, int VEC>
__device__ __forceinline__ void rc_stage(T* buf, const T* q, const T* t,
                                         const int* lines, int my_row,
                                         int my_col, int k0, int D, int lane) {
#pragma unroll
  for (int u = 0; u < rc_slots<VEC>(); ++u) {
    int line;
    if constexpr (VEC >= 4) {
      line = lines[u];
    } else {
      line = rc_line<VEC>(my_row, my_col, u, lane);
    }
    rc_copy<T, VEC>(buf, q, t, line, u, k0, D, lane);
  }
}

template <typename T, int VEC>
__global__ void __launch_bounds__(TC_THREADS)
rank_recount_kernel(const T* __restrict__ q, const T* __restrict__ t,
                    const int32_t* __restrict__ work, int work_capacity,
                    const unsigned long long* __restrict__ recounted,
                    const T* __restrict__ pivot, int D, float atol,
                    float rtol, int epilogue,
                    int32_t* __restrict__ greater_out,
                    int32_t* __restrict__ close_out) {
  extern __shared__ __align__(16) unsigned char rc_smem[];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  T* ring = reinterpret_cast<T*>(rc_smem) + warp * RC_STAGES * RC_CHUNK;
  const long long fill = min((long long)recounted[1], (long long)work_capacity);
  const int n_chunks = (D + RC_K - 1) / RC_K;
  for (long long base = ((long long)blockIdx.x * (TC_THREADS / 32) + warp) * 32;
       base < fill; base += (long long)gridDim.x * TC_THREADS) {
    const long long i = base + lane;
    int row = -1, col = -1;
    if (i < fill) {
      row = work[2 * i];  // -1: a slot reserved by a block that recounted
      col = row >= 0 ? work[2 * i + 1] : -1;
    }
    if (row < 0) col = -1;
    int lines[VEC >= 4 ? rc_slots<VEC>() : 1];
    if constexpr (VEC >= 4) {
#pragma unroll
      for (int u = 0; u < rc_slots<VEC>(); ++u)
        lines[u] = rc_line<VEC>(row, col, u, lane);
    }
#pragma unroll
    for (int c = 0; c < RC_STAGES - 1; ++c) {
      if (c < n_chunks)
        rc_stage<T, VEC>(ring + c * RC_CHUNK, q, t, lines, row, col, c * RC_K,
                         D, lane);
      cp_async_commit();
    }
    float acc = 0.0f;
    for (int c = 0; c < n_chunks; ++c) {
      const int next = c + RC_STAGES - 1;
      if (next < n_chunks)
        rc_stage<T, VEC>(ring + (next % RC_STAGES) * RC_CHUNK, q, t, lines, row,
                         col, next * RC_K, D, lane);
      cp_async_commit();
      cp_async_wait<RC_STAGES - 1>();
      __syncwarp();
      const T* a = ring + (c % RC_STAGES) * RC_CHUNK + lane * RC_ES;
      const T* b = a + RC_LD;
      const int len = min(RC_K, D - c * RC_K);
      if (len == RC_K) {
#pragma unroll
        for (int kk = 0; kk < RC_K; kk += 8) {
          float x[8], y[8];
          widen8<T>(*reinterpret_cast<const uint4*>(a + kk), x);
          widen8<T>(*reinterpret_cast<const uint4*>(b + kk), y);
#pragma unroll
          for (int j = 0; j < 8; ++j) acc = __fmaf_rn(x[j], y[j], acc);
        }
      } else {
        for (int kk = 0; kk < len; ++kk)
          acc = __fmaf_rn(Prec<T>::load(a + kk), Prec<T>::load(b + kk), acc);
      }
      __syncwarp();  // the chunk's buffer is refilled next
    }
    cp_async_wait<0>();
    __syncwarp();
    if (row >= 0) {
      float p = Prec<T>::load(pivot + row);
      p = isnan(p) ? -INFINITY : p;
      int cl, gr;
      close_greater_as<T>(Prec<T>::score(acc, epilogue), p,
                          Prec<T>::tol(atol, rtol, p), cl, gr);
      if (gr) atomicAdd(greater_out + row, 1);
      if (cl) atomicAdd(close_out + row, 1);
    }
  }
}

template <typename T, int VEC>
struct RecountLaunch {
  template <typename... Args>
  static cudaError_t run(unsigned blocks, cudaStream_t s, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        rank_recount_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        RC_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    rank_recount_kernel<T, VEC><<<blocks, TC_THREADS, RC_SMEM_BYTES, s>>>(args...);
    return cudaGetLastError();
  }
};

// The raw tensor-core sums of the [n, num_cols] block: tc_tile_product, as
// the tile kernel calls it, written out.
template <typename T, int VEC>
__global__ void __launch_bounds__(TC_THREADS, 2)
tc_tile_sums_kernel(const T* __restrict__ q, const T* __restrict__ t, int n,
                    int D, int num_cols, float* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char tc_smem[];
  T* smem = reinterpret_cast<T*>(tc_smem);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int wm = warp >> 1, wn = warp & 1;
  const int row0 = blockIdx.x * BM, c0 = blockIdx.y * BN;
  float acc[TC_MI][TC_NI][4], chain = 0.0f;
  tc_tile_product<T, VEC>(acc, smem, q, t, row0, c0, n, num_cols, D, -1, 0,
                          chain);
#pragma unroll
  for (int mi = 0; mi < TC_MI; ++mi) {
#pragma unroll
    for (int ni = 0; ni < TC_NI; ++ni) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = row0 + wm * TC_WM + mi * 16 + (e >> 1) * 8 + (lane >> 2);
        const int col = c0 + wn * TC_WN + ni * 8 + (lane & 3) * 2 + (e & 1);
        if (row < n && col < num_cols)
          out[(size_t)row * num_cols + col] = acc[mi][ni][e];
      }
    }
  }
}

// How the tensor cores read float16, subnormals above all: every ordered
// pair (a, b) of float16 bit patterns goes through mma.sync m16n8k16 (f16
// in, float32 accumulators from 0) with one nonzero k per output, so that
// each accumulator holds the one product a b, and is held against the exact
// float32 product (__fmul_rn of the widened values: at most 22 significant
// bits between 2^-48 and 2^32, so no rounding). Equal means equal values
// (+0 and -0 alike: the zero terms of the mma may change a zero's sign) or
// NaN on both sides. counts[0, 3): the pairs with neither, one, both
// operands subnormal; counts[3, 6): the pairs among them whose sum differs;
// counts[6]: of those, the sums that are 0 where the product is not (a
// flushed operand). A warp does one mma a job. For finite b (7,936 blocks of
// 8 values) the diagonal layout: A[m][k] = a_base + m where k = m, else 0;
// B[k][n] = b_base + n for every k; so C[m][n] = (a_base + m)(b_base + n),
// 128 pairs a job (the zeros of A meet only finite values of B). For the 256
// blocks of infinities and NaNs among the b, 0 x b would be NaN, so there A
// holds one a on its diagonal and B holds b_base + n only at k = n: C[n][n],
// n < 8, is a (b_base + n) plus products of zeros, 8 pairs a job.
constexpr int SUB_A_BLOCKS = 65536 / 16;       // a_base = 16 x block
constexpr int SUB_FINITE_B_BLOCKS = 7936;      // b blocks without inf or NaN
constexpr unsigned SUB_DIAGONAL_JOBS = SUB_A_BLOCKS * SUB_FINITE_B_BLOCKS;
constexpr unsigned SUB_JOBS = SUB_DIAGONAL_JOBS + 65536u * 256;

__device__ __forceinline__ bool f16_subnormal(unsigned h) {
  return (h & 0x7c00u) == 0 && (h & 0x3ffu) != 0;
}

__device__ __forceinline__ unsigned pack_f16(unsigned lo, unsigned hi) {
  return (lo & 0xffffu) | (hi << 16);
}

__global__ void __launch_bounds__(256)
f16_subnormal_check_kernel(unsigned long long* __restrict__ counts) {
  unsigned long long pairs[3] = {0, 0, 0}, differ[3] = {0, 0, 0}, flushed = 0;
  const int lane = threadIdx.x & 31;
  const int g = lane >> 2, tq = lane & 3;
  const unsigned warps = gridDim.x * (blockDim.x >> 5);
  for (unsigned job = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
       job < SUB_JOBS; job += warps) {
    const bool diagonal = job < SUB_DIAGONAL_JOBS;
    unsigned a_of[2], b_base;  // a of rows g and g + 8
    if (diagonal) {
      const unsigned a_base = job / SUB_FINITE_B_BLOCKS * 16;
      const unsigned bb = job % SUB_FINITE_B_BLOCKS;
      // blocks below 0x7c00, then from 0x8000 below 0xfc00
      b_base = bb < 3968 ? bb * 8 : 0x8000u + (bb - 3968) * 8;
      a_of[0] = a_base + g;
      a_of[1] = a_base + g + 8;
    } else {
      const unsigned rest = job - SUB_DIAGONAL_JOBS;
      const unsigned a = rest >> 8, bb = rest & 255;
      b_base = (bb < 128 ? 0x7c00u : 0xfc00u) + (bb & 127) * 8;
      a_of[0] = a_of[1] = a;
    }
    // A: a0 (row g, k 2 tq, 2 tq + 1), a1 (row g + 8), a2 and a3 (k + 8)
    unsigned a[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int row = g + (r & 1) * 8, k = 2 * tq + (r >> 1) * 8;
      const unsigned v = a_of[r & 1];
      a[r] = pack_f16(k == row ? v : 0u, k + 1 == row ? v : 0u);
    }
    // B: b0 (k 2 tq, 2 tq + 1; column g), b1 (k + 8)
    const unsigned bv = b_base + g;
    unsigned b[2];
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      const int k = 2 * tq + r * 8;
      b[r] = diagonal ? pack_f16(bv, bv)
                      : pack_f16(k == g ? bv : 0u, k + 1 == g ? bv : 0u);
    }
    float c[4] = {0.0f, 0.0f, 0.0f, 0.0f};
    mma_f16(c, a, b[0], b[1]);
    // c[e]: row g + (e / 2) 8, column 2 tq + e % 2
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int row = g + (e >> 1) * 8, col = 2 * tq + (e & 1);
      const bool valid = diagonal || (row == col && row < 8);
      if (!valid) continue;
      const unsigned x = a_of[e >> 1], y = b_base + col;
      const float want = __fmul_rn(__half2float(__ushort_as_half((unsigned short)x)),
                                   __half2float(__ushort_as_half((unsigned short)y)));
      const bool same = c[e] == want || (isnan(c[e]) && isnan(want));
      const int cls = (int)f16_subnormal(x) + (int)f16_subnormal(y);
#pragma unroll
      for (int k = 0; k < 3; ++k) {  // registers, not an indexed array
        pairs[k] += cls == k;
        differ[k] += cls == k && !same;
      }
      flushed += !same && c[e] == 0.0f && want != 0.0f;
    }
  }
  unsigned long long v[7] = {pairs[0], pairs[1], pairs[2], differ[0],
                             differ[1], differ[2], flushed};
#pragma unroll
  for (int k = 0; k < 7; ++k) {
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      v[k] += __shfl_xor_sync(0xffffffffu, v[k], off);
    if (lane == 0 && v[k]) atomicAdd(counts + k, v[k]);
  }
}

// norm_bound of rows [0, n) of q into norms[0, n) and of rows [0, num_cols)
// of t into norms[n, n + num_cols): the prologue's 16-bit norm blocks.
template <typename T>
__global__ void __launch_bounds__(PROLOGUE_THREADS)
norm_bounds_kernel(const T* __restrict__ q, const T* __restrict__ t, int n,
                   int D, int num_cols, float* __restrict__ norms) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int v = blockIdx.x * PIVOT_ROWS + warp;
  if (v >= n + num_cols) return;
  const bool vec8 = (D & 7) == 0 && aligned16(q) && aligned16(t);
  const T* src = v < n ? q + (size_t)v * D : t + (size_t)(v - n) * D;
  const float bound = norm_bound<T>(src, D, lane, vec8);
  if (lane == 0) norms[v] = bound;
}

// Elements per staging copy that D and the operands' alignment allow.
int tc_vec(const void* q, const void* t, int D) {
  const uintptr_t base =
      reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(t);
  for (int vec = 8; vec > 1; vec >>= 1)
    if (D % vec == 0 && (base & (2 * vec - 1)) == 0) return vec;
  return 1;
}

// Launch kernel<T, VEC> for the VEC that tc_vec chose, after allowing its
// dynamic shared memory.
template <typename T, template <typename, int> class Launch, typename... Args>
cudaError_t launch_tc(int vec, Args... args) {
  switch (vec) {
    case 8: return Launch<T, 8>::run(args...);
    case 4: return Launch<T, 4>::run(args...);
    case 2: return Launch<T, 2>::run(args...);
    default: return Launch<T, 1>::run(args...);
  }
}

template <typename T, int VEC>
struct TilesLaunch {
  template <typename... Args>
  static cudaError_t run(dim3 grid, cudaStream_t s, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        rank_tiles_tc_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TC_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    rank_tiles_tc_kernel<T, VEC><<<grid, TC_THREADS, TC_SMEM_BYTES, s>>>(args...);
    return cudaGetLastError();
  }
};

template <typename T, int VEC>
struct SumsLaunch {
  template <typename... Args>
  static cudaError_t run(dim3 grid, cudaStream_t s, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        tc_tile_sums_kernel<T, VEC>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        TC_SMEM_BYTES);
    if (err != cudaSuccess) return err;
    tc_tile_sums_kernel<T, VEC><<<grid, TC_THREADS, TC_SMEM_BYTES, s>>>(args...);
    return cudaGetLastError();
  }
};

}  // namespace

// The pivot blocks of the prologue alone (rank_pivots): each row's chain
// score at column pivot_cols[row] - col_lo of t [num_valid, D], -0.0 where
// that column lies outside [0, num_valid).
template <typename T>
int rank_pivots_launch_as(const T* q, const T* t, const int32_t* pivot_cols,
                          int n, int D, int num_valid, int col_lo,
                          int epilogue, T* pivot_out, void* stream) {
  if (n <= 0) return 0;
  if (epilogue != EPILOGUE_NONE && epilogue != EPILOGUE_NEG_SQRT_L2)
    return (int)cudaErrorInvalidValue;
  const int pivot_blocks = (n + PIVOT_ROWS - 1) / PIVOT_ROWS;
  rank_prologue_kernel<T><<<pivot_blocks, PROLOGUE_THREADS, 0,
                            (cudaStream_t)stream>>>(
      q, t, pivot_cols, nullptr, col_lo, nullptr, nullptr, n, D, num_valid,
      0, 0, pivot_blocks, 0, epilogue, 0.0f, 0.0f, pivot_out, nullptr,
      nullptr, nullptr, nullptr, nullptr, nullptr);
  return (int)cudaGetLastError();
}

template <typename T>
int rank_counts_launch_as(const T* q, const T* t, const int32_t* pivot_cols,
                          const T* pivot_in,
                          const int32_t* row_ptr, const int32_t* cols, int n,
                          int D, int num_valid, int nnz, float atol,
                          float rtol, int epilogue, int tiles_per_range,
                          int32_t* tile_ptr, int32_t* greater_out,
                          int32_t* close_out, T* vals_out, T* pivot_out,
                          float* norms, int32_t* work, int work_capacity,
                          unsigned long long* recounted, void* stream) {
  // the 16-bit types run on the tensor cores, float32 on the CUDA cores
  constexpr bool kTensorCores = !std::is_same<T, float>::value;
  if (n <= 0) return 0;
  if (tiles_per_range < 1) return (int)cudaErrorInvalidValue;
  if (epilogue != EPILOGUE_NONE && epilogue != EPILOGUE_NEG_SQRT_L2)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int num_tiles = (num_valid + BN - 1) / BN;
  const int pivot_blocks = (n + PIVOT_ROWS - 1) / PIVOT_ROWS;
  const int norm_blocks =
      kTensorCores
          ? (int)(((long long)n + num_valid + PIVOT_ROWS - 1) / PIVOT_ROWS)
          : 0;
  const size_t entries = (size_t)n * (num_tiles + 1);
  const size_t fill = entries > (size_t)nnz ? entries : (size_t)nnz;
  size_t fill_blocks = (fill + PROLOGUE_THREADS - 1) / PROLOGUE_THREADS;
  if (fill_blocks > 4096) fill_blocks = 4096;
  rank_prologue_kernel<T><<<pivot_blocks + norm_blocks + (unsigned)fill_blocks,
                         PROLOGUE_THREADS, 0, s>>>(
      q, t, pivot_cols, pivot_in, 0, row_ptr, cols, n, D, num_valid,
      num_tiles, nnz, pivot_blocks, norm_blocks, epilogue, atol, rtol,
      pivot_out, greater_out, close_out, tile_ptr, vals_out, norms,
      recounted);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || num_tiles == 0) return (int)err;
  const int ranges = (num_tiles + tiles_per_range - 1) / tiles_per_range;
  if (ranges > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((n + BM - 1) / BM, ranges);
  if constexpr (kTensorCores) {
    const int vec = tc_vec(q, t, D);
    err = launch_tc<T, TilesLaunch>(
        vec, grid, s, q, t, cols, (const int32_t*)tile_ptr,
        (const T*)pivot_out, (const float*)norms, n, D, num_valid,
        num_tiles, tiles_per_range, atol, rtol, epilogue, greater_out,
        close_out, vals_out, work, work_capacity, recounted);
    if (err != cudaSuccess || work_capacity <= 0) return (int)err;
    // one block an SM at most (the ring takes most of its shared memory),
    // each walking the worklist in steps of the grid
    int device = 0, sms = 0;
    err = cudaGetDevice(&device);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
    if (err != cudaSuccess) return (int)err;
    const long long blocks = ((long long)work_capacity + TC_THREADS - 1) / TC_THREADS;
    return (int)launch_tc<T, RecountLaunch>(
        vec, (unsigned)(blocks < sms ? blocks : sms), s, q, t,
        (const int32_t*)work, work_capacity,
        (const unsigned long long*)recounted,
        (const T*)pivot_out, D, atol, rtol, epilogue, greater_out,
        close_out);
  } else {
    err = allow_shared_memory();
    if (err != cudaSuccess) return (int)err;
    rank_tiles_kernel<<<grid, THREADS, SMEM_BYTES, s>>>(
        q, t, cols, tile_ptr, pivot_out, n, D, num_valid, num_tiles,
        tiles_per_range, atol, rtol, epilogue, greater_out, close_out,
        vals_out);
    return (int)cudaGetLastError();
  }
}

template <typename T>
int rank_counts_tile_sums_as(const T* q, const T* t, int n, int D,
                             int num_cols, float* out, float* norms,
                             void* stream) {
  if (n <= 0 || num_cols <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  const long long vectors = (long long)n + num_cols;
  norm_bounds_kernel<T><<<(unsigned)((vectors + PIVOT_ROWS - 1) / PIVOT_ROWS),
                          PROLOGUE_THREADS, 0, s>>>(q, t, n, D, num_cols, norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int col_tiles = (num_cols + BN - 1) / BN;
  if (col_tiles > 65535) return (int)cudaErrorInvalidValue;
  dim3 grid((n + BM - 1) / BM, col_tiles);
  return (int)launch_tc<T, SumsLaunch>(tc_vec(q, t, D), grid, s, q, t, n, D,
                                       num_cols, out);
}

extern "C" {

// Candidate columns per tile: the caller plans its column ranges in whole
// tiles of this width.
int rank_counts_tile_cols() { return BN; }

// Query rows per block.
int rank_counts_tile_rows() { return BM; }

// Launches both kernels on `stream`; returns the CUDA error code of the
// first launch that failed (0 = ok). `epilogue` names the score epilogue
// (EPILOGUE_*). The pivot of row i is its own score at column pivot_cols[i],
// or pivot_in[i] where pivot_in is given (pivot_cols is then unread), and
// is written to pivot_out. Every output is written
// here, zeros included: greater, close [n], vals [nnz], pivot_out [n].
// tile_ptr: scratch of n * (ceil(num_valid / tile_cols) + 1) int32. The plan:
// the columns cut into ranges of tiles_per_range tiles, one block per (row
// tile, range).
int rank_counts_launch(const float* q, const float* t,
                       const int32_t* pivot_cols, const float* pivot_in,
                       const int32_t* row_ptr,
                       const int32_t* cols, int n, int D, int num_valid,
                       int nnz, float atol, float rtol, int epilogue,
                       int tiles_per_range, int32_t* tile_ptr,
                       int32_t* greater_out, int32_t* close_out,
                       float* vals_out, float* pivot_out, void* stream) {
  return rank_counts_launch_as<float>(
      q, t, pivot_cols, pivot_in, row_ptr, cols, n, D, num_valid, nnz, atol,
      rtol,
      epilogue, tiles_per_range, tile_ptr, greater_out, close_out, vals_out,
      pivot_out, nullptr, nullptr, 0, nullptr, stream);
}

// The same for bfloat16 q and t: the bfloat16 path of the header, on the
// tensor cores; vals_out and pivot_out are bfloat16 [nnz] and [n]. Scratch:
// norms, float32 [3 n + num_valid] (the certificate's norm bounds of the
// rows and the candidates, then each row's two category cuts); work, int32
// [2 work_capacity] (the recount launch's worklist: a block whose
// undecided entries do not fit recounts them itself). Output: recounted
// [2]: the entries the certificate left undecided, then the slots the
// blocks reserved on the worklist (both written here). A third launch
// recounts the worklist.
int rank_counts_launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* t,
                            const int32_t* pivot_cols,
                            const __nv_bfloat16* pivot_in,
                            const int32_t* row_ptr,
                            const int32_t* cols, int n, int D, int num_valid,
                            int nnz, float atol, float rtol, int epilogue,
                            int tiles_per_range, int32_t* tile_ptr,
                            int32_t* greater_out, int32_t* close_out,
                            __nv_bfloat16* vals_out, __nv_bfloat16* pivot_out,
                            float* norms, int32_t* work, int work_capacity,
                            unsigned long long* recounted, void* stream) {
  return rank_counts_launch_as<__nv_bfloat16>(
      q, t, pivot_cols, pivot_in, row_ptr, cols, n, D, num_valid, nnz, atol,
      rtol,
      epilogue, tiles_per_range, tile_ptr, greater_out, close_out, vals_out,
      pivot_out, norms, work, work_capacity, recounted, stream);
}

// The same for float16 q and t: the float16 path of the header, on the
// tensor cores with the bfloat16 path's certificate, scratch and outputs;
// vals_out and pivot_out are float16 [nnz] and [n].
int rank_counts_launch_f16(const __half* q, const __half* t,
                           const int32_t* pivot_cols, const __half* pivot_in,
                           const int32_t* row_ptr, const int32_t* cols, int n,
                           int D, int num_valid, int nnz, float atol,
                           float rtol, int epilogue, int tiles_per_range,
                           int32_t* tile_ptr, int32_t* greater_out,
                           int32_t* close_out, __half* vals_out,
                           __half* pivot_out, float* norms, int32_t* work,
                           int work_capacity, unsigned long long* recounted,
                           void* stream) {
  return rank_counts_launch_as<__half>(
      q, t, pivot_cols, pivot_in, row_ptr, cols, n, D, num_valid, nnz, atol,
      rtol, epilogue, tiles_per_range, tile_ptr, greater_out, close_out,
      vals_out, pivot_out, norms, work, work_capacity, recounted, stream);
}

// rank_pivots: each row's chain score (after the epilogue) at column
// pivot_cols[row] - col_lo of t [num_valid, D] into pivot_out [n], -0.0
// where that column lies outside [0, num_valid): over the column shards of
// a table, one rank holds each pivot and the others' -0.0 leave the sum
// equal to it in every bit. The prologue's pivot blocks alone.
int rank_pivots_launch(const float* q, const float* t,
                       const int32_t* pivot_cols, int n, int D, int num_valid,
                       int col_lo, int epilogue, float* pivot_out,
                       void* stream) {
  return rank_pivots_launch_as<float>(q, t, pivot_cols, n, D, num_valid,
                                      col_lo, epilogue, pivot_out, stream);
}

int rank_pivots_launch_bf16(const __nv_bfloat16* q, const __nv_bfloat16* t,
                            const int32_t* pivot_cols, int n, int D,
                            int num_valid, int col_lo, int epilogue,
                            __nv_bfloat16* pivot_out, void* stream) {
  return rank_pivots_launch_as<__nv_bfloat16>(q, t, pivot_cols, n, D,
                                              num_valid, col_lo, epilogue,
                                              pivot_out, stream);
}

int rank_pivots_launch_f16(const __half* q, const __half* t,
                           const int32_t* pivot_cols, int n, int D,
                           int num_valid, int col_lo, int epilogue,
                           __half* pivot_out, void* stream) {
  return rank_pivots_launch_as<__half>(q, t, pivot_cols, n, D, num_valid,
                                       col_lo, epilogue, pivot_out, stream);
}

// The exhaustive check of the tensor cores' float16 products
// (f16_subnormal_check_kernel) into counts[7], zeroed by the caller.
int rank_counts_f16_subnormal_check(unsigned long long* counts, void* stream) {
  f16_subnormal_check_kernel<<<132 * 16, 256, 0, (cudaStream_t)stream>>>(counts);
  return (int)cudaGetLastError();
}

// For checks of the certificate: the tensor cores' float32 sums of
// q [n, D] x t[:num_cols]^T into out [n, num_cols], by the tile kernel's own
// product (tc_tile_product), and the norm bounds of the prologue into
// norms [n + num_cols] (rows of q, then of t).
int rank_counts_tile_sums_bf16(const __nv_bfloat16* q, const __nv_bfloat16* t,
                               int n, int D, int num_cols, float* out,
                               float* norms, void* stream) {
  return rank_counts_tile_sums_as<__nv_bfloat16>(q, t, n, D, num_cols, out,
                                                 norms, stream);
}

int rank_counts_tile_sums_f16(const __half* q, const __half* t, int n, int D,
                              int num_cols, float* out, float* norms,
                              void* stream) {
  return rank_counts_tile_sums_as<__half>(q, t, n, D, num_cols, out, norms,
                                          stream);
}

}  // extern "C"
