// Deterministic scatter-add of row updates into a dense table gradient, and
// segment sums of row updates, for Hopper: the sort included.
//
// Replaces the TPU kernel kge_tpu/ops/pallas_ops.py sorted_scatter_add (body
// _scatter_kernel), the backward of every embedding lookup
// (_pallas_gather_bwd), together with the sort that its wrapper runs before
// it. With ids UNSORTED it computes
//   out = zeros[num_rows, D];  out[ids[p]] += upd[p]  for p in [0, n)
// (ids outside [0, num_rows) are skipped), or, "by segment", one summed row
// per distinct id in ascending id order, which the row-sparse optimizer step
// takes. Every row of out is written exactly once, zeros included.
//
// The TPU kernel sums a row tile's update range with one-hot matmuls and a
// 3-way bf16 split to reach f32 accuracy on the MXU. Neither is carried
// over: these are plain f32 adds.
//
// Two launches on the caller's stream.
//
// Launch A, blocked_sort_kernel: a stable least-significant-digit radix sort
// of (key, position) pairs spread over the SMs, one cooperative launch whose
// phases meet at grid-wide barriers.
//  - The key of an id is itself inside the table and num_rows outside it, so
//    those sort last. The sort runs on the bits_of(num_rows) bits the keys
//    have (14 for 14,541 rows, 18 for 200,000) in the fewest passes of at
//    most 8 bits, the bits shared evenly: two passes of 7 bits at 14, three
//    of 6 at 18, one at 237 rows.
//  - The positions are cut into tiles of 256 x rounds consecutive positions,
//    one tile a block, at most 128 tiles (rounds = 1 up to 32,768 ids). A
//    pass: every block ranks its own tile by the pass's digit, stably (a
//    warp groups equal digits with __match_any_sync; per-warp counts, scanned
//    warp after warp, give each position its rank among the tile's equal
//    digits). The tiles' digit counts, read digit-major and tile-minor, give
//    each (digit, tile) its first place: the counts of all smaller digits
//    plus those of the digit in earlier tiles. Each block then writes its
//    keys and positions there, in ascending position within a digit, so the
//    pass is stable, and counts for the next pass, by warp-aggregated
//    integer atomics, the digits each tile of the new order receives; pass
//    0's counts are written by the blocks themselves before the first
//    barrier. Integer counts do not depend on the order of the atomics, so
//    the sort is exact: it equals a stable sort of the keys.
//  - Then every block marks where a run of equal keys starts in its tile of
//    the sorted order, counts the starts, and after a last barrier numbers
//    them from the counts of the tiles before it: seg[p], the number of the
//    segment of sorted position p, and seg_begin[s], where segment s starts
//    (seg_begin[segments] = n), meta[0] = segments. For the scatter-add each
//    start also sets its key's bit in a bitmap of the table's rows, from
//    which launch B knows the rows to zero.
//  - Barriers: passes + 2 (four at 14 bits; none where one block holds all
//    the ids). A caller that holds a sort passes it in; launch A then
//    converts it to 32 bits and marks. Up to SORT_LIMIT ids: above about
//    that many a stable torch.sort and launch A on its sort take as long.
//  - The intermediate passes use seg and seg_begin as their buffer; both are
//    written only once the sort is done.
//
// Launch B, segment_sums_kernel. Every output row is summed by one owner in
// ascending sorted position, with no float atomics, so two launches on the
// same input give the same bits. Segment lengths are wildly skewed (a
// popular relation owns thousands of the 8,192 updates of a batch, most
// entities own one to three, mini-table ids are an arange), so the sum has
// two fixed-order levels:
//  1. The sorted positions are cut into chunks of CHUNK = 32. A block owns
//     a chunk and a slab of up to 128 16-byte columns, one column a thread.
//     It has all the chunk's update rows in flight before the first add,
//     with the segment edges staged in shared memory, and sums each piece (a
//     maximal run of one key inside the chunk) in order. A piece that is a
//     whole segment is written to out. A piece cut by a chunk edge goes to
//     a scratch slot of its chunk: slot 0 for the chunk's first piece,
//     slot 1 for its last.
//  2. A cut segment is finished by whichever of its chunks' blocks is done
//     last (a counter per segment, after a fence): it adds the scratch
//     slots of the chunks the segment covers in ascending chunk order and
//     writes the row. The order of the adds is the same whoever is last.
// The rows no id names are zeroed by extra blocks of launch B, spread over
// the table: a run of rows whose bits launch A left clear, or, by segment,
// the rows past the last segment, each run's bytes stored by all the
// block's threads in turn. So each row of out is written once: present rows
// by their owner, the others by the extra blocks. Launch B is a
// programmatic dependent launch: it waits for launch A in the kernel.
//
// Bound: bytes. Each update row is read once and each output row written
// once; there is one add per element read. At n = 8,192, D = 512 and 14,541
// rows that is 16.8 MB read and 29.8 MB written: 0.014 ms at the card's
// memory rate in float32, 0.007 ms in bfloat16. Launch A moves few bytes
// and is bound by latency: its launch, its grid barriers (about 1 us each,
// 4.2 us of its 0.015 ms at that shape on an NVIDIA H100 80GB HBM3, 700 W,
// measured by doubling them) and the memory round trips between them.
// Launch B moves the bytes. PERF.md has the times launch by launch
// (scripts/scatter_timing.py).
//
// bfloat16 (parallel.param_dtype: bfloat16; scatter_add_launch_bf16): upd
// and out are bfloat16, the sums and the scratch float32, as kge_tpu's kernel
// sums in float32 scratch and writes the updates' dtype. Launch B widens
// each element as it loads it and rounds each output element once as it
// stores it, 8 columns a thread in 16-byte loads and stores (4 columns in 8
// bytes where D is not a multiple of 8, 1 where it is not of 4); the order
// of the adds is the float32 path's. Half the bytes move, so the bound
// halves. Launch A is the same for every type.
//
// float16 (parallel.param_dtype: float16; scatter_add_launch_f16): the same
// as bfloat16, with float16 in its place. A float16 element widens to
// float32 exactly too, and each output element is rounded once, so a sum
// above 65,504 in magnitude stores as an infinity, as kge_tpu's float16
// output does.

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int CHUNK = 32;         // sorted positions per block of launch B
constexpr int MAX_THREADS_B = 128;
constexpr int AHEAD = 8;          // scratch rows loaded ahead of their adds
constexpr int ZERO_BLOCKS_PER_SM = 4;  // launch B's blocks for absent rows
constexpr int SORT_THREADS = 256; // threads of a block of launch A
constexpr int SORT_WARPS = SORT_THREADS / 32;
constexpr int MAX_DIGITS = 256;   // 8 bits a pass at most
constexpr int MAX_TILES = 128;    // blocks of launch A
constexpr int MAX_ROUNDS = 16;    // SORT_THREADS positions each, a tile
constexpr int SORT_LIMIT = MAX_TILES * MAX_ROUNDS * SORT_THREADS;

// 8 neighbouring columns, summed in float32
struct float8 {
  float4 a, b;
};

__device__ __forceinline__ float vzero(const float*) { return 0.f; }
__device__ __forceinline__ float4 vzero(const float4*) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ float8 vzero(const float8*) {
  return {vzero((const float4*)nullptr), vzero((const float4*)nullptr)};
}
__device__ __forceinline__ void vadd(float& a, const float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}
__device__ __forceinline__ void vadd(float8& a, const float8& b) {
  vadd(a.a, b.a);
  vadd(a.b, b.b);
}

// The 2-byte element types, bfloat16 and float16: a value widens to float32
// exactly, and a float32 sum rounds to nearest even where it is stored.
template <typename T>
struct Two;
template <>
struct Two<__nv_bfloat16> {
  __device__ static float widen(__nv_bfloat16 r) { return __bfloat162float(r); }
  __device__ static __nv_bfloat16 narrow(float v) {
    return __float2bfloat16_rn(v);
  }
  __device__ static float2 widen2(unsigned raw) {
    return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw));
  }
  __device__ static unsigned narrow2(float x, float y) {
    const __nv_bfloat162 v = __floats2bfloat162_rn(x, y);
    return *reinterpret_cast<const unsigned*>(&v);
  }
};
template <>
struct Two<__half> {
  __device__ static float widen(__half r) { return __half2float(r); }
  __device__ static __half narrow(float v) { return __float2half_rn(v); }
  __device__ static float2 widen2(unsigned raw) {
    return __half22float2(*reinterpret_cast<const __half2*>(&raw));
  }
  __device__ static unsigned narrow2(float x, float y) {
    const __half2 v = __floats2half2_rn(x, y);
    return *reinterpret_cast<const unsigned*>(&v);
  }
};

// Loads and stores of a V (float, float4 or float8 of neighbouring columns)
// at index i in units of V of a float, bfloat16 or float16 array. A load
// brings the raw bytes (Raw) and widen() turns them into float32 where they
// are added: a 2-byte element widens exactly. A sum is rounded once to the
// 2-byte type (round to nearest even) where it is stored.
template <typename V, typename T, bool NARROW = sizeof(T) == 2>
struct Elem;
template <typename V>
struct Elem<V, float, false> {
  using Raw = V;
  __device__ static Raw load(const float* p, size_t i) {
    return reinterpret_cast<const V*>(p)[i];
  }
  __device__ static V widen(const Raw& r) { return r; }
  __device__ static void store(float* p, size_t i, const V& v) {
    reinterpret_cast<V*>(p)[i] = v;
  }
};
template <typename T>
struct Elem<float, T, true> {
  using Raw = T;
  __device__ static Raw load(const T* p, size_t i) { return p[i]; }
  __device__ static float widen(const Raw& r) { return Two<T>::widen(r); }
  __device__ static void store(T* p, size_t i, float v) {
    p[i] = Two<T>::narrow(v);
  }
};
template <typename T>
struct Elem<float4, T, true> {
  using Raw = uint2;
  __device__ static Raw load(const T* p, size_t i) {
    return reinterpret_cast<const uint2*>(p)[i];
  }
  __device__ static float4 widen(const Raw& r) {
    const float2 a = Two<T>::widen2(r.x), b = Two<T>::widen2(r.y);
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static void store(T* p, size_t i, float4 v) {
    reinterpret_cast<uint2*>(p)[i] =
        make_uint2(Two<T>::narrow2(v.x, v.y), Two<T>::narrow2(v.z, v.w));
  }
};
template <typename T>
struct Elem<float8, T, true> {
  using Raw = uint4;
  __device__ static Raw load(const T* p, size_t i) {
    return reinterpret_cast<const uint4*>(p)[i];
  }
  __device__ static float8 widen(const Raw& r) {
    const float2 a = Two<T>::widen2(r.x), b = Two<T>::widen2(r.y),
                 c = Two<T>::widen2(r.z), d = Two<T>::widen2(r.w);
    return {make_float4(a.x, a.y, b.x, b.y), make_float4(c.x, c.y, d.x, d.y)};
  }
  __device__ static void store(T* p, size_t i, const float8& v) {
    reinterpret_cast<uint4*>(p)[i] = make_uint4(
        Two<T>::narrow2(v.a.x, v.a.y), Two<T>::narrow2(v.a.z, v.a.w),
        Two<T>::narrow2(v.b.x, v.b.y), Two<T>::narrow2(v.b.z, v.b.w));
  }
};

__device__ __forceinline__ long long index_at(const void* a, bool wide,
                                              size_t i) {
  return wide ? (long long)static_cast<const int64_t*>(a)[i]
              : (long long)static_cast<const int32_t*>(a)[i];
}

// the sort key of an id: itself inside the table, num_keys outside
__device__ __forceinline__ int32_t key_of(const void* ids, bool wide,
                                          size_t i, int num_keys) {
  const long long v = index_at(ids, wide, i);
  return (v < 0 || v >= num_keys) ? num_keys : (int32_t)v;
}

// Exclusive prefix of `value` over the block's threads in thread order, and
// the block's total. tmp: 33 ints of shared memory. All threads call it.
__device__ __forceinline__ int block_exclusive_scan(int value, int* tmp,
                                                    int& total) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  int incl = value;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int up = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += up;
  }
  if (lane == 31) tmp[warp] = incl;
  __syncthreads();
  if (warp == 0) {
    const int mine = lane < (int)(blockDim.x >> 5) ? tmp[lane] : 0;
    int sum = mine;
#pragma unroll
    for (int off = 1; off < 32; off <<= 1) {
      const int up = __shfl_up_sync(0xffffffffu, sum, off);
      if (lane >= off) sum += up;
    }
    tmp[lane] = sum - mine;
    if (lane == 31) tmp[32] = sum;
  }
  __syncthreads();
  const int base = tmp[warp];
  total = tmp[32];
  __syncthreads();  // tmp is free for the next call
  return base + incl - value;
}

int bits_of(int value) {  // bits needed to hold 0..value
  int bits = 1;
  while ((value >> bits) != 0) ++bits;
  return bits;
}

// How launch A cuts the work: tiles of rounds x SORT_THREADS positions (one
// block each), and passes of digit_bits bits (0 passes for a caller's sort).
struct SortPlan {
  int tiles, rounds, passes, digit_bits;
};

SortPlan sort_plan(int n, int num_keys, bool presorted) {
  SortPlan plan;
  plan.rounds = 1;
  while ((long long)plan.rounds * SORT_THREADS * MAX_TILES < n) plan.rounds *= 2;
  const int tile = plan.rounds * SORT_THREADS;
  plan.tiles = n > 0 ? (n + tile - 1) / tile : 1;
  const int key_bits = bits_of(num_keys);
  plan.passes = presorted ? 0 : (key_bits + 7) / 8;
  plan.digit_bits = plan.passes ? (key_bits + plan.passes - 1) / plan.passes : 1;
  return plan;
}

struct SortArgs {
  const void* ids;
  int ids_wide, ids_stride;
  const void* order_in;  // a caller's sort, or null
  int order_wide;
  int n, num_keys;
  SortPlan plan;
  int32_t* keys_sorted;  // [n]
  int32_t* order;        // [n]
  int32_t* seg;          // [n]; keys of the intermediate passes before
  int32_t* seg_begin;    // [n + 1]; positions of the intermediate passes before
  int32_t* meta;         // [1]: the number of segments
  int32_t* counts;       // [passes, tiles, 2^digit_bits]
  int32_t* tile_starts;  // [tiles]
  uint32_t* present;     // a bit per key below num_keys, or null (by segment)
  int present_words;
  int32_t* done;         // launch B's counters, zeroed here
  int num_done;
};

// Rank the tile's keys (s_key, the first `len`) by the digit at `shift`:
// s_rank[i] = how many of the tile's positions before i hold i's digit, and
// s_run[d] = how many hold d. Stable: position order is round-major,
// thread-minor, as the ranks count.
__device__ __forceinline__ void rank_tile(const uint32_t* s_key, uint16_t* s_rank,
                                          int* s_run, int (*s_wc)[MAX_DIGITS],
                                          int len, int rounds, int shift,
                                          int digits) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  for (int d = tid; d < digits; d += SORT_THREADS) s_run[d] = 0;
  for (int r = 0; r < rounds; ++r) {
    for (int w = 0; w < SORT_WARPS; ++w)
      for (int d = tid; d < digits; d += SORT_THREADS) s_wc[w][d] = 0;
    __syncthreads();
    const int i = r * SORT_THREADS + tid;
    const bool valid = i < len;
    const int digit = valid ? (int)((s_key[i] >> shift) & (digits - 1)) : MAX_DIGITS;
    const unsigned peers = __match_any_sync(0xffffffffu, digit);
    const int below = __popc(peers & ((1u << lane) - 1u));
    if (valid && below == 0) s_wc[warp][digit] = __popc(peers);
    __syncthreads();
    // each digit's count before every warp of the round, warp after warp
    for (int d = tid; d < digits; d += SORT_THREADS) {
      int run = s_run[d];
#pragma unroll
      for (int w = 0; w < SORT_WARPS; ++w) {
        const int c = s_wc[w][d];
        s_wc[w][d] = run;
        run += c;
      }
      s_run[d] = run;
    }
    __syncthreads();
    if (valid) s_rank[i] = (uint16_t)(s_wc[warp][digit] + below);
    __syncthreads();  // s_wc is zeroed again by the next round
  }
}

// A grid-wide barrier; a grid of one block needs only the block's.
__device__ __forceinline__ void sync_grid(cg::grid_group& grid) {
  if (gridDim.x == 1) {
    __syncthreads();
  } else {
    grid.sync();
  }
}

__global__ void __launch_bounds__(SORT_THREADS)
blocked_sort_kernel(const SortArgs a) {
  extern __shared__ __align__(16) unsigned char sort_smem[];
  __shared__ int s_wc[SORT_WARPS][MAX_DIGITS];
  __shared__ int s_run[MAX_DIGITS];
  __shared__ int s_off[MAX_DIGITS];
  __shared__ int tmp[33];
  cg::grid_group grid = cg::this_grid();
  const SortPlan& plan = a.plan;
  const int tile = plan.rounds * SORT_THREADS;
  uint32_t* s_key = reinterpret_cast<uint32_t*>(sort_smem);
  int32_t* s_pos = reinterpret_cast<int32_t*>(s_key + tile);
  uint16_t* s_rank = reinterpret_cast<uint16_t*>(s_pos + tile);
  int* s_cnt = reinterpret_cast<int*>(s_rank + tile);  // [tiles, digits]
  const int tid = threadIdx.x, t = blockIdx.x;
  const int first = t * tile;
  const int len = max(0, min(tile, a.n - first));
  const int digits = 1 << plan.digit_bits;
  const size_t per_pass = (size_t)plan.tiles * digits;

  // zeros over launch B's counters, the bitmap and the counts that later
  // passes add to
  {
    const size_t at = (size_t)t * SORT_THREADS + tid;
    const size_t step = (size_t)gridDim.x * SORT_THREADS;
    for (size_t i = at; i < (size_t)a.num_done; i += step) a.done[i] = 0;
    if (a.present != nullptr)
      for (size_t i = at; i < (size_t)a.present_words; i += step) a.present[i] = 0;
    if (plan.passes > 1)
      for (size_t i = at; i < (plan.passes - 1) * per_pass; i += step)
        a.counts[per_pass + i] = 0;
  }
  if (plan.passes == 0) {
    // a caller's sort: its keys and permutation, as they are
    for (int i = tid; i < len; i += SORT_THREADS) {
      const size_t p = (size_t)first + i;
      a.keys_sorted[p] =
          key_of(a.ids, a.ids_wide != 0, p * a.ids_stride, a.num_keys);
      a.order[p] = (int32_t)index_at(a.order_in, a.order_wide != 0, p);
    }
    sync_grid(grid);
  } else {
    for (int i = tid; i < len; i += SORT_THREADS) {
      const size_t p = (size_t)first + i;
      s_key[i] = (uint32_t)key_of(a.ids, a.ids_wide != 0, p * a.ids_stride,
                                  a.num_keys);
      s_pos[i] = (int32_t)p;
    }
    __syncthreads();
  }

  for (int pass = 0; pass < plan.passes; ++pass) {
    const int shift = pass * plan.digit_bits;
    const bool last = pass + 1 == plan.passes;
    // the pass's source and destination: the last pass ends in keys_sorted
    // and order, the ones before alternate with seg and seg_begin
    const bool to_final = ((plan.passes - 1 - pass) & 1) == 0;
    int32_t* dst_key = to_final ? a.keys_sorted : a.seg;
    int32_t* dst_pos = to_final ? a.order : a.seg_begin;
    int32_t* counts = a.counts + pass * per_pass;
    // every digit's first place in this tile: the counts of the smaller
    // digits in all tiles, then of the digit in the tiles before this one;
    // the tiles' counts are staged in shared memory, all loads in flight
    const auto place_digits = [&]() {
      if (per_pass % 4 == 0) {
        const int4* from = reinterpret_cast<const int4*>(counts);
        int4* to = reinterpret_cast<int4*>(s_cnt);
#pragma unroll 8
        for (size_t e = tid; e < per_pass / 4; e += SORT_THREADS) to[e] = __ldcg(from + e);
      } else {
#pragma unroll 8
        for (size_t e = tid; e < per_pass; e += SORT_THREADS) s_cnt[e] = __ldcg(counts + e);
      }
      __syncthreads();
      int total = 0, before = 0;
      if (tid < digits) {
        for (int u = 0; u < plan.tiles; ++u) {
          const int c = s_cnt[u * digits + tid];
          total += c;
          before += u < t ? c : 0;
        }
      }
      int all;
      const int smaller = block_exclusive_scan(total, tmp, all);
      if (tid < digits) s_off[tid] = smaller + before;
    };
    if (pass == 0) {
      rank_tile(s_key, s_rank, s_run, s_wc, len, plan.rounds, shift, digits);
      for (int d = tid; d < digits; d += SORT_THREADS)
        counts[(size_t)t * digits + d] = s_run[d];
      sync_grid(grid);
      place_digits();
    } else {
      // the pass before counted this pass's digits; their loads overlap
      // those of the tile's first round
      const int32_t* src_key = to_final ? a.seg : a.keys_sorted;
      const int32_t* src_pos = to_final ? a.seg_begin : a.order;
      int key0 = 0, pos0 = 0;
      if (tid < len) {
        key0 = __ldcg(src_key + first + tid);
        pos0 = __ldcg(src_pos + first + tid);
      }
      place_digits();
      if (tid < len) {
        s_key[tid] = (uint32_t)key0;
        s_pos[tid] = pos0;
      }
      for (int i = tid + SORT_THREADS; i < len; i += SORT_THREADS) {
        s_key[i] = (uint32_t)__ldcg(src_key + first + i);
        s_pos[i] = __ldcg(src_pos + first + i);
      }
      __syncthreads();
      rank_tile(s_key, s_rank, s_run, s_wc, len, plan.rounds, shift, digits);
    }
    __syncthreads();
    int32_t* next = a.counts + (pass + 1) * per_pass;
    for (int r = 0; r < plan.rounds; ++r) {
      const int i = r * SORT_THREADS + tid;
      const bool valid = i < len;
      int tag = -1;
      int32_t* slot = nullptr;
      if (valid) {
        const uint32_t key = s_key[i];
        const int q = s_off[(key >> shift) & (digits - 1)] + s_rank[i];
        dst_key[q] = (int32_t)key;
        dst_pos[q] = s_pos[i];
        if (!last) {
          const int d2 = (int)((key >> (shift + plan.digit_bits)) & (digits - 1));
          tag = (q / tile) * MAX_DIGITS + d2;
          slot = next + (size_t)(q / tile) * digits + d2;
        }
      }
      if (!last) {
        // one atomic per group of equal (tile, digit) in a warp
        const unsigned peers = __match_any_sync(0xffffffffu, tag);
        if (valid && __popc(peers & ((1u << (tid & 31)) - 1u)) == 0)
          atomicAdd(slot, __popc(peers));
      }
    }
    sync_grid(grid);
  }

  // segment marks over the tile of the sorted order: count the starts, then,
  // once every tile has, number them from the counts of the tiles before
  unsigned marks = 0;  // bit r: the position of round r starts a segment
  const auto starts_at = [&](int r) {
    const int i = r * SORT_THREADS + tid;
    if (r < 32) return ((marks >> r) & 1u) != 0;
    const int p = first + i;
    return i < len && (p == 0 || __ldcg(a.keys_sorted + p) !=
                                     __ldcg(a.keys_sorted + p - 1));
  };
  int count = 0;
  for (int r = 0; r < plan.rounds; ++r) {
    const int i = r * SORT_THREADS + tid;
    const int p = first + i;
    bool starts = false;
    if (i < len) {
      const int key = __ldcg(a.keys_sorted + p);
      starts = p == 0 || key != __ldcg(a.keys_sorted + p - 1);
      if (starts && a.present != nullptr && key < a.num_keys)
        atomicOr(a.present + (key >> 5), 1u << (key & 31));
    }
    if (r < 32) marks |= (starts ? 1u : 0u) << r;
    count += __syncthreads_count(starts);
  }
  if (tid == 0) a.tile_starts[t] = count;
  sync_grid(grid);
  int earlier = 0;
  for (int u = tid; u < t; u += SORT_THREADS) earlier += __ldcg(a.tile_starts + u);
  int segment;  // the number of the tile's first segment
  block_exclusive_scan(earlier, tmp, segment);
  if (t == plan.tiles - 1 && tid == 0) {
    a.seg_begin[segment + count] = a.n;
    a.meta[0] = segment + count;
  }
  for (int r = 0; r < plan.rounds; ++r) {
    const int i = r * SORT_THREADS + tid;
    const bool starts = starts_at(r);
    int total;
    const int s = segment + block_exclusive_scan(starts ? 1 : 0, tmp, total) +
                  (starts ? 1 : 0) - 1;
    if (i < len) {
      a.seg[first + i] = s;
      if (starts) a.seg_begin[s] = first + i;
    }
    segment += total;
  }
}

__device__ __forceinline__ float load_global(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float4 load_global(const float4* p) {
  return __ldcg(p);
}
__device__ __forceinline__ float8 load_global(const float8* p) {
  const float4* q = reinterpret_cast<const float4*>(p);
  return {__ldcg(q), __ldcg(q + 1)};
}

// Blocks [0, num_chunks) x slabs: the two-level sums. Blocks past
// num_chunks: zeros over the rows no id names (a clear bit of `present`),
// or, by segment, over the rows past the last segment.
// Dv is the row length in units of V; a thread owns one column of V.
template <typename V, typename T>
__global__ void __launch_bounds__(MAX_THREADS_B)
segment_sums_kernel(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ seg,
                    const int32_t* __restrict__ seg_begin,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ meta,
                    const uint32_t* __restrict__ present,
                    const T* __restrict__ upd, int n, int Dv, int out_rows,
                    int num_chunks, int by_segment, T* __restrict__ out,
                    V* partial, int32_t* done) {
  // launched as a programmatic dependent of launch A: wait here for all of
  // launch A (or whatever kernel ran before) and its writes
  asm volatile("griddepcontrol.wait;" ::: "memory");
  using E = Elem<V, T>;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + tid;
  const bool active = col < Dv;
  const V zero = vzero((const V*)nullptr);

  if (b >= num_chunks) {
    // zeros over contiguous runs of absent rows, each run's units of V
    // shared by the threads of all slabs: few instructions a store
    const int step = gridDim.x - num_chunks;
    const int lane = blockIdx.y * blockDim.x + tid;
    const int lanes = gridDim.y * blockDim.x;
    if (by_segment) {  // the rows past the last segment: one run
      const size_t end = (size_t)out_rows * Dv;
#pragma unroll 4
      for (size_t e = (size_t)meta[0] * Dv + (size_t)(b - num_chunks) * lanes + lane;
           e < end; e += (size_t)step * lanes)
        E::store(out, e, zero);
      return;
    }
    // groups of 32 rows, one word of the bitmap each; a run of clear bits
    // is a run of rows to zero
    const int groups = (out_rows + 31) / 32;
    for (int g = b - num_chunks; g < groups; g += step) {
      const int rows = min(32, out_rows - g * 32);
      uint32_t absent = ~__ldcg(present + g) & (rows == 32 ? ~0u : (1u << rows) - 1u);
      while (absent != 0u) {
        const int r0 = __ffs(absent) - 1;
        const uint32_t run = ~(absent >> r0);  // the first set bit ends the run
        const int len = run == 0u ? 32 - r0 : __ffs(run) - 1;
        absent &= len == 32 ? 0u : ~(((1u << len) - 1u) << r0);
        const size_t end = (size_t)(g * 32 + r0 + len) * Dv;
#pragma unroll 4
        for (size_t e = (size_t)(g * 32 + r0) * Dv + lane; e < end; e += lanes)
          E::store(out, e, zero);
      }
    }
    return;
  }

  __shared__ int s_row[CHUNK];   // the output row of each position
  __shared__ int s_src[CHUNK];   // its row of upd
  __shared__ int s_edge[CHUNK];  // 1 where a piece ends
  __shared__ int s_jobs;
  __shared__ int s_job[2][4];    // first chunk, last chunk, row, first slot
  const int p0 = b * CHUNK;
  const int p1 = min(p0 + CHUNK, n);
  const int len = p1 - p0;
  if (tid < len) {
    const int p = p0 + tid;
    const int key = keys[p];
    s_row[tid] = by_segment ? seg[p] : key;
    s_src[tid] = order[p];
    s_edge[tid] = (tid + 1 == len || keys[p + 1] != key) ? 1 : 0;
  }
  // does the chunk's first piece start its segment, its last piece end it?
  const bool starts = (p0 == 0) || (keys[p0 - 1] != keys[p0]);
  const bool ends = (p1 == n) || (keys[p1] != keys[p1 - 1]);
  __syncthreads();

  if (active) {
    V acc = zero;
    int piece_start = 0;
    // update rows in flight before the first of their adds: a whole chunk
    // in float32, half of one in bfloat16, where widening them takes the
    // registers of the other half
    constexpr int ROWS_AHEAD = sizeof(T) == 4 ? CHUNK : CHUNK / 2;
    for (int i0 = 0; i0 < len; i0 += ROWS_AHEAD) {
      typename E::Raw v[ROWS_AHEAD];
#pragma unroll
      for (int u = 0; u < ROWS_AHEAD; ++u)
        if (i0 + u < len) v[u] = E::load(upd, (size_t)s_src[i0 + u] * Dv + col);
#pragma unroll
      for (int u = 0; u < ROWS_AHEAD; ++u) {
        const int i = i0 + u;
        if (i >= len) break;
        vadd(acc, E::widen(v[u]));
        if (s_edge[i]) {
          const int row = s_row[i];
          const bool whole =
              (piece_start > 0 || starts) && (i + 1 < len || ends);
          if (row >= 0 && row < out_rows) {
            if (whole) {
              E::store(out, (size_t)row * Dv + col, acc);
            } else {
              const int slot = piece_start > 0 ? 1 : 0;
              partial[((size_t)b * 2 + slot) * Dv + col] = acc;
            }
          }
          acc = zero;
          piece_start = i + 1;
        }
      }
    }
  }

  // Level 2. A chunk holds at most two cut pieces: its first and its last.
  // Each counts its segment's chunks as done; the last one to do so adds the
  // segment's scratch slots in ascending chunk order.
  __threadfence();
  __syncthreads();
  if (tid == 0) {
    int jobs = 0;
    int first_end = 0;
    while (!s_edge[first_end]) ++first_end;
    const bool one_piece = first_end == len - 1;
    const bool cut[2] = {
        !(starts && (!one_piece || ends)),  // the first piece
        !one_piece && !ends,                // the last piece, if another
    };
    const int at[2] = {0, len - 1};
    for (int k = 0; k < 2; ++k) {
      const int row = s_row[at[k]];
      if (!cut[k] || row < 0 || row >= out_rows) continue;
      const int s = seg[p0 + at[k]];
      const int from = seg_begin[s], to = seg_begin[s + 1];
      const int first_chunk = from / CHUNK, last_chunk = (to - 1) / CHUNK;
      const int arrived = atomicAdd(
          done + (size_t)blockIdx.y * num_chunks + first_chunk, 1);
      if (arrived == last_chunk - first_chunk) {
        // zero again, so that launch B can run anew on the same work
        done[(size_t)blockIdx.y * num_chunks + first_chunk] = 0;
        s_job[jobs][0] = first_chunk;
        s_job[jobs][1] = last_chunk;
        s_job[jobs][2] = row;
        s_job[jobs][3] = from % CHUNK ? 1 : 0;
        ++jobs;
      }
    }
    s_jobs = jobs;
  }
  __syncthreads();
  const int jobs = s_jobs;
  if (jobs == 0 || !active) return;
  __threadfence();
  for (int k = 0; k < jobs; ++k) {
    const int first_chunk = s_job[k][0], last_chunk = s_job[k][1];
    V acc = load_global(partial +
                        ((size_t)first_chunk * 2 + s_job[k][3]) * Dv + col);
    for (int c0 = first_chunk + 1; c0 <= last_chunk; c0 += AHEAD) {
      V v[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
        if (c0 + u <= last_chunk)
          v[u] = load_global(partial + (size_t)(c0 + u) * 2 * Dv + col);
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
        if (c0 + u <= last_chunk) vadd(acc, v[u]);
    }
    E::store(out, (size_t)s_job[k][2] * Dv + col, acc);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

int threads_for(int Dv) {
  const int t = (Dv + 31) / 32 * 32;
  return t < 32 ? 32 : (t > MAX_THREADS_B ? MAX_THREADS_B : t);
}

// Offsets (in int32 words) of the scratch `work`: keys_sorted [n], order
// [n], seg [n], seg_begin [n + 1], meta [1], launch B's counters, launch A's
// counts, its tiles' starts and the bitmap of keys present.
struct WorkLayout {
  size_t done, counts, tile_starts, present, words;
  int present_words;
};

WorkLayout work_layout(int n, int D, int num_keys) {
  const int num_chunks = (n + CHUNK - 1) / CHUNK;
  const int threads = threads_for(D);
  const SortPlan plan = sort_plan(n, num_keys, false);
  WorkLayout w;
  w.done = 4 * (size_t)n + 2;
  w.counts = w.done + (size_t)num_chunks * ((D + threads - 1) / threads);
  w.counts = (w.counts + 3) / 4 * 4;  // 16-byte aligned for vector loads
  w.tile_starts = w.counts + (size_t)plan.passes * plan.tiles * (1 << plan.digit_bits);
  w.present = w.tile_starts + plan.tiles;
  w.present_words = num_keys / 32 + 1;
  w.words = w.present + w.present_words;
  return w;
}

template <typename V, typename T>
int launch_sums(const int32_t* keys, const int32_t* seg,
                const int32_t* seg_begin, const int32_t* order,
                const int32_t* meta, const uint32_t* present, const T* upd,
                int n, int Dv, int out_rows, int num_chunks, int by_segment,
                int zero_blocks, T* out, float* partial, int32_t* done,
                cudaStream_t stream) {
  const int threads = threads_for(Dv);
  const int slabs = (Dv + threads - 1) / threads;
  if (num_chunks + zero_blocks == 0) return 0;
  // a programmatic dependent launch: its blocks may be launched as launch
  // A's blocks exit, and wait in the kernel for A's writes, which narrows
  // the gap between the two
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(num_chunks + zero_blocks, slabs);
  config.blockDim = dim3(threads);
  config.stream = stream;
  cudaLaunchAttribute attribute;
  attribute.id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attribute.val.programmaticStreamSerializationAllowed = 1;
  config.attrs = &attribute;
  config.numAttrs = 1;
  return (int)cudaLaunchKernelEx(&config, segment_sums_kernel<V, T>, keys, seg,
                                 seg_begin, order, meta, present, upd, n, Dv,
                                 out_rows, num_chunks, by_segment, out,
                                 (V*)partial, done);
}

}  // namespace

template <typename T>
int scatter_add_launch_as(const void* ids, int ids_wide, int ids_stride,
                          const void* order_in, int order_wide, const T* upd,
                          int n, int D, int num_keys, int by_segment, T* out,
                          int out_rows, int32_t* work, float* partial,
                          int phases, void* stream) {
  if (D <= 0 || out_rows <= 0 || n < 0 || num_keys < 0)
    return D < 0 || n < 0 || num_keys < 0 ? (int)cudaErrorInvalidValue : 0;
  if (order_in == nullptr && n > SORT_LIMIT) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int num_chunks = (n + CHUNK - 1) / CHUNK;
  const WorkLayout layout = work_layout(n, D, num_keys);
  int32_t* keys_sorted = work;
  int32_t* order = work + n;
  int32_t* seg = work + 2 * (size_t)n;
  int32_t* seg_begin = work + 3 * (size_t)n;
  int32_t* meta = work + 4 * (size_t)n + 1;
  int32_t* done = work + layout.done;
  uint32_t* present =
      by_segment ? nullptr : reinterpret_cast<uint32_t*>(work + layout.present);
  // 16-byte rows of upd and out: 4 float32 or 8 bfloat16 columns a thread;
  // else 4 columns in 8 bytes (bfloat16), else one column
  const bool rows16 = aligned16(partial) && aligned16(upd) && aligned16(out) &&
                      (D * sizeof(T)) % 16 == 0;
  const bool rows8 = sizeof(T) == 2 && D % 4 == 0 && aligned16(partial) &&
                     ((uintptr_t)upd % 8) == 0 && ((uintptr_t)out % 8) == 0;
  const int width = rows16 ? 16 / (int)sizeof(T) : rows8 ? 4 : 1;
  const int Dv = D / width;
  const int threads = threads_for(Dv);
  const int num_done = num_chunks * ((Dv + threads - 1) / threads);

  if (phases & 1) {
    SortArgs args;
    args.ids = ids;
    args.ids_wide = ids_wide;
    args.ids_stride = ids_stride;
    args.order_in = order_in;
    args.order_wide = order_wide;
    args.n = n;
    args.num_keys = num_keys;
    args.plan = sort_plan(n, num_keys, order_in != nullptr);
    args.keys_sorted = keys_sorted;
    args.order = order;
    args.seg = seg;
    args.seg_begin = seg_begin;
    args.meta = meta;
    args.counts = work + layout.counts;
    args.tile_starts = work + layout.tile_starts;
    args.present = present;
    args.present_words = layout.present_words;
    args.done = done;
    args.num_done = num_done;
    // the tile's keys, positions and ranks and all tiles' digit counts, for
    // the passes only
    const size_t smem =
        args.plan.passes ? (size_t)args.plan.rounds * SORT_THREADS * 10 +
                               ((size_t)args.plan.tiles * 4 << args.plan.digit_bits)
                         : 0;
    if (smem > 32 * 1024) {
      // static shared memory counts against the 48 KB that need no opt-in
      cudaError_t err = cudaFuncSetAttribute(
          blocked_sort_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
          (int)smem);
      if (err != cudaSuccess) return (int)err;
    }
    void* params[] = {&args};
    cudaError_t err = cudaLaunchCooperativeKernel(
        (const void*)blocked_sort_kernel, dim3(args.plan.tiles),
        dim3(SORT_THREADS), params, smem, s);
    if (err != cudaSuccess) return (int)err;
  }
  if (phases & 2) {
    // of the current device, asked at every call: a process may hold cards
    // of different sizes
    int device = 0, sm_count = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
    if (sm_count <= 0) sm_count = 1;
    // the extra blocks for the rows no id names, up to ZERO_BLOCKS_PER_SM a
    // multiprocessor: a group of 32 rows each, by segment 8 rows
    int zero_blocks = (out_rows + (by_segment ? 7 : 31)) / (by_segment ? 8 : 32);
    if (zero_blocks > ZERO_BLOCKS_PER_SM * sm_count)
      zero_blocks = ZERO_BLOCKS_PER_SM * sm_count;
    if constexpr (sizeof(T) == 2) {
      if (width == 8) {
        return launch_sums<float8, T>(keys_sorted, seg, seg_begin, order, meta,
                                      present, upd, n, Dv, out_rows, num_chunks,
                                      by_segment, zero_blocks, out, partial,
                                      done, s);
      }
    }
    if (width == 4) {
      return launch_sums<float4, T>(keys_sorted, seg, seg_begin, order, meta,
                                    present, upd, n, Dv, out_rows, num_chunks,
                                    by_segment, zero_blocks, out, partial, done, s);
    }
    return launch_sums<float, T>(keys_sorted, seg, seg_begin, order, meta,
                                 present, upd, n, Dv, out_rows, num_chunks,
                                 by_segment, zero_blocks, out, partial, done, s);
  }
  return 0;
}

extern "C" {

// Positions the in-kernel sort takes; above it the caller passes a sort.
int scatter_add_sort_limit() { return SORT_LIMIT; }

// Sorted positions per block of launch B: the scratch `partial` holds
// [ceil(n / chunk), 2, D] floats.
int scatter_add_chunk() { return CHUNK; }

// Launch A's plan for n unsorted ids of a table of num_keys rows: tiles,
// rounds of 256 positions a tile, passes and bits a pass, into plan[4].
void scatter_add_sort_plan(int n, int num_keys, int32_t* plan) {
  const SortPlan p = sort_plan(n, num_keys, false);
  plan[0] = p.tiles;
  plan[1] = p.rounds;
  plan[2] = p.passes;
  plan[3] = p.digit_bits;
}

// int32 words of the scratch `work` for n ids of a table of num_keys rows
// and rows of D elements: keys_sorted [n], order [n], seg [n], seg_begin
// [n + 1], meta [1], then launch B's counters and launch A's counts, its
// tiles' segment starts and a bitmap of the keys present.
int scatter_add_work_ints(int n, int D, int num_keys) {
  return (int)work_layout(n, D, num_keys).words;
}

// Launches on `stream`; returns the CUDA error code of the first launch
// that failed (0 = ok).
//   ids [n]: int64 (ids_wide) or int32, ids_stride elements apart (a column
//     of a batch of triples serves as it is), in any order; with order_in (int64
//     or int32) they are sorted ascending already and order_in[p] is the row
//     of upd that sorted position p came from. Without order_in, n must not
//     exceed scatter_add_sort_limit().
//   upd [n, D]; num_keys: the table's rows (ids outside [0, num_keys) take
//     the key num_keys and are skipped).
//   by_segment = 0: out [out_rows = num_keys, D] is the scatter-add.
//   by_segment = 1: out [out_rows = n, D] holds in row s the sum of the
//     s-th segment of equal keys, zeros past the last segment.
//   work, partial: scratch as above. After the call work holds keys_sorted,
//     order and seg (the segment number of every sorted position).
//   phases: 1 = launch A only, 2 = launch B only (on the work of an earlier
//     launch A), 3 = both.
int scatter_add_launch(const void* ids, int ids_wide, int ids_stride,
                       const void* order_in, int order_wide, const float* upd,
                       int n, int D, int num_keys, int by_segment, float* out,
                       int out_rows, int32_t* work, float* partial,
                       int phases, void* stream) {
  return scatter_add_launch_as<float>(ids, ids_wide, ids_stride, order_in,
                                      order_wide, upd, n, D, num_keys,
                                      by_segment, out, out_rows, work, partial,
                                      phases, stream);
}

// The same for bfloat16 upd and out: each row of out is summed in float32
// (partial holds float32) and rounded once to bfloat16 when it is stored.
int scatter_add_launch_bf16(const void* ids, int ids_wide, int ids_stride,
                            const void* order_in, int order_wide,
                            const __nv_bfloat16* upd, int n, int D,
                            int num_keys, int by_segment, __nv_bfloat16* out,
                            int out_rows, int32_t* work, float* partial,
                            int phases, void* stream) {
  return scatter_add_launch_as<__nv_bfloat16>(
      ids, ids_wide, ids_stride, order_in, order_wide, upd, n, D, num_keys,
      by_segment, out, out_rows, work, partial, phases, stream);
}

// The same for float16 upd and out, rounded once to float16 when stored.
int scatter_add_launch_f16(const void* ids, int ids_wide, int ids_stride,
                           const void* order_in, int order_wide,
                           const __half* upd, int n, int D, int num_keys,
                           int by_segment, __half* out, int out_rows,
                           int32_t* work, float* partial, int phases,
                           void* stream) {
  return scatter_add_launch_as<__half>(
      ids, ids_wide, ids_stride, order_in, order_wide, upd, n, D, num_keys,
      by_segment, out, out_rows, work, partial, phases, stream);
}

}  // extern "C"
