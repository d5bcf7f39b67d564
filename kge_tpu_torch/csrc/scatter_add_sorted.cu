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
// takes. The whole of out is written here, zeros included.
//
// The TPU kernel sums a row tile's update range with one-hot matmuls and a
// 3-way bf16 split to reach f32 accuracy on the MXU. Neither is carried
// over: these are plain f32 adds.
//
// Two launches on the caller's stream.
//
// Launch A, sort_and_zero_kernel. Block 0 sorts; the other blocks stream
// zeros over out with 16-byte stores meanwhile, which takes about as long.
//  - The sort is a stable least-significant-digit radix sort of (key,
//    position) pairs by one block of 1,024 threads, on the
//    ceil(log2(num_rows + 1)) bits that the keys have only (14 for 14,541
//    rows, 18 for 200,000), 4 bits a pass. The key of an id outside the
//    table is num_rows, so those sort last. The ids are read with
//    neighbouring threads on neighbouring words and staged in shared memory;
//    a thread then holds 1, 4, 8, 12 or 17 consecutive positions in
//    registers (the smallest that holds n): key and position in one 32-bit
//    word where their bits allow (14 + 13 for 8,192 ids of 14,541 rows),
//    else a 32-bit key and a 16-bit position. They are ranked and exchanged
//    through shared memory by cub::BlockRadixSort, a building block inside
//    this kernel. 17 x 1,024 positions bound n at SORT_LIMIT; above it the
//    caller sorts. The result equals a stable sort of the keys exactly.
//    (Two hand-written sorts with up to 8 bits a pass were tried and were
//    slower a pass by more than their fewer passes saved: one ranked with a
//    warp vote per bit, and the votes were its cost; one counted into
//    per-thread byte counters.)
//  - Then the same block marks where a run of equal keys starts (the sorted
//    keys are still in shared memory) and scans the marks, 1,024 positions
//    at a time: seg[p], the number of the segment of sorted position p, and
//    seg_begin[s], where segment s starts (seg_begin[segments] = n); every
//    store has neighbouring threads on neighbouring words. A caller that
//    holds a sort passes it in; block 0 then only converts it to 32 bits
//    and scans.
//
// Launch B, segment_sums_kernel. Every output row is summed by one owner in
// ascending sorted position, with no float atomics, so two launches on the
// same input give the same bits. Segment lengths are wildly skewed (a
// popular relation owns thousands of the 8,192 updates of a batch, most
// entities own one to three, mini-table ids are an arange), so the sum has
// two fixed-order levels:
//  1. The sorted positions are cut into chunks of CHUNK = 32. A block owns
//     a chunk and a slab of up to 128 16-byte columns, one column a thread.
//     It loads the update rows of 8 positions ahead of adding them, with
//     the segment edges staged in shared memory, and sums each piece (a
//     maximal run of one key inside the chunk) in order. A piece that is a
//     whole segment is written to out. A piece cut by a chunk edge goes to
//     a scratch slot of its chunk: slot 0 for the chunk's first piece,
//     slot 1 for its last.
//  2. A cut segment is finished by whichever of its chunks' blocks is done
//     last (a counter per segment, after a fence): it adds the scratch
//     slots of the chunks the segment covers in ascending chunk order and
//     writes the row. The order of the adds is the same whoever is last.
// Present rows are written, not added, over launch A's zeros. By segment,
// rows of out past the last segment are zeroed by extra blocks of launch B.
//
// Bound: bytes. Each update row is read once and each output row written
// once; there is one add per element read. At n = 8,192, D = 512 and 14,541
// rows that is 16.8 MB read and 29.8 MB written: 0.014 ms at the card's
// memory rate. Measured on an NVIDIA H100 80GB HBM3 (700 W) at that shape:
// about 0.038 ms a call, launch A 0.021 ms (the sort's latency on one SM;
// the zeros alone take 0.011 ms) and launch B 0.011 to 0.015 ms (PERF.md has
// the table).
//
// bfloat16 (parallel.param_dtype: bfloat16; scatter_add_launch_bf16): upd
// and out are bfloat16, the sums and the scratch float32, as kge_tpu's kernel
// sums in float32 scratch and writes the updates' dtype. Launch B widens
// each element as it loads it and rounds each output element once as it
// stores it (4 columns a thread, 8-byte loads); the order of the adds is the
// float32 path's. Half the bytes move, so the bound halves.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <type_traits>

namespace {

constexpr int CHUNK = 32;         // sorted positions per block of launch B
constexpr int MAX_THREADS_B = 128;
constexpr int AHEAD = 8;          // rows loaded ahead of their adds
constexpr int SORT_THREADS = 1024;
constexpr int MAX_ITEMS = 17;     // positions per thread of the largest sort
constexpr int SORT_LIMIT = MAX_ITEMS * SORT_THREADS;  // the in-kernel sort's

__device__ __forceinline__ float vzero(const float*) { return 0.f; }
__device__ __forceinline__ float4 vzero(const float4*) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void vadd(float& a, const float b) { a += b; }

// Loads and stores of a V (float, or float4 of 4 neighbouring columns) at
// element index 4 i (float4) or i (float) of a float or bfloat16 array: a
// bfloat16 element widens exactly, and a sum is rounded once to bfloat16
// (round to nearest even) where it is stored.
template <typename V, typename T>
struct Elem;
template <>
struct Elem<float, float> {
  __device__ static float load(const float* p, size_t i) { return p[i]; }
  __device__ static void store(float* p, size_t i, float v) { p[i] = v; }
};
template <>
struct Elem<float4, float> {
  __device__ static float4 load(const float* p, size_t i) {
    return reinterpret_cast<const float4*>(p)[i];
  }
  __device__ static void store(float* p, size_t i, float4 v) {
    reinterpret_cast<float4*>(p)[i] = v;
  }
};
template <>
struct Elem<float, __nv_bfloat16> {
  __device__ static float load(const __nv_bfloat16* p, size_t i) {
    return __bfloat162float(p[i]);
  }
  __device__ static void store(__nv_bfloat16* p, size_t i, float v) {
    p[i] = __float2bfloat16_rn(v);
  }
};
template <>
struct Elem<float4, __nv_bfloat16> {
  __device__ static float4 load(const __nv_bfloat16* p, size_t i) {
    const uint2 raw = reinterpret_cast<const uint2*>(p)[i];
    const float2 a = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b = __bfloat1622float2(
        *reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    return make_float4(a.x, a.y, b.x, b.y);
  }
  __device__ static void store(__nv_bfloat16* p, size_t i, float4 v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v.x, v.y);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v.z, v.w);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&a);
    raw.y = *reinterpret_cast<const unsigned*>(&b);
    reinterpret_cast<uint2*>(p)[i] = raw;
  }
};
__device__ __forceinline__ void vadd(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

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

// Index into a shared-memory buffer padded by one word in 32, so that
// threads that read runs of consecutive words do not meet in one bank.
__device__ __forceinline__ int padded(int i) { return i + (i >> 5); }

// The sorted keys of launch A, wherever they lie: in shared memory, padded,
// or in device memory.
struct SortedKeys {
  const uint32_t* words;
  bool pad;
  __device__ __forceinline__ int operator()(int i) const {
    return (int)words[pad ? padded(i) : i];
  }
};

// Stable radix sort of (key, position) by the whole block; the sorted keys
// and positions go to keys_sorted and order in device memory. A thread
// holds ITEMS consecutive positions; positions past n take the largest key
// and, coming last among equal keys, stay past n. PACKED: key and position
// share one 32-bit word (the key above pos_bits bits of position), sorted
// on the key's bits only, which halves what a pass ranks and exchanges;
// else the positions ride along as 16-bit values.
template <int ITEMS, bool PACKED>
struct BlockSort {
  using Sort = typename std::conditional<
      PACKED, cub::BlockRadixSort<uint32_t, SORT_THREADS, ITEMS>,
      cub::BlockRadixSort<uint32_t, SORT_THREADS, ITEMS, uint16_t>>::type;
  static constexpr size_t TEMP_BYTES =
      (sizeof(typename Sort::TempStorage) + 15) / 16 * 16;
  static constexpr int WORDS = ITEMS * SORT_THREADS;
  // the sort's scratch, then the sorted keys (padded by one word in 32)
  static constexpr size_t BYTES = TEMP_BYTES + (WORDS + WORDS / 32) * 4;

  // Returns the shared-memory buffer of the sorted keys (padded).
  static __device__ const uint32_t* run(const void* ids, bool wide,
                                        int ids_stride, int n, int num_keys,
                                        int key_bits, int pos_bits,
                                        unsigned char* smem,
                                        int32_t* __restrict__ keys_sorted,
                                        int32_t* __restrict__ order) {
    uint32_t* sorted = reinterpret_cast<uint32_t*>(smem + TEMP_BYTES);
    typename Sort::TempStorage& temp =
        *reinterpret_cast<typename Sort::TempStorage*>(smem);
    const int tid = threadIdx.x;
    // neighbouring threads read neighbouring ids; a thread then takes its
    // run of ITEMS consecutive positions from shared memory
    for (int i = tid; i < n; i += SORT_THREADS) {
      sorted[padded(i)] =
          (uint32_t)key_of(ids, wide, (size_t)i * ids_stride, num_keys);
    }
    __syncthreads();
    uint32_t keys[ITEMS];
    uint16_t pos[ITEMS];
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = tid * ITEMS + k;
      const uint32_t key = i < n ? sorted[padded(i)] : 0u;
      if (PACKED) {
        keys[k] = i < n ? (key << pos_bits) | (uint32_t)i : 0xffffffffu;
      } else {
        keys[k] = i < n ? key : 0xffffffffu;
        pos[k] = (uint16_t)i;
      }
    }
    __syncthreads();  // `sorted` is free for the result
    if constexpr (PACKED) {
      Sort(temp).SortBlockedToStriped(keys, pos_bits, pos_bits + key_bits);
    } else {
      Sort(temp).SortBlockedToStriped(keys, pos, 0, key_bits);
    }
#pragma unroll
    for (int k = 0; k < ITEMS; ++k) {
      const int i = k * SORT_THREADS + tid;
      if (i < n) {
        const uint32_t key = PACKED ? keys[k] >> pos_bits : keys[k];
        sorted[padded(i)] = key;
        keys_sorted[i] = (int32_t)key;
        order[i] = (int32_t)(PACKED ? keys[k] & ((1u << pos_bits) - 1u)
                                    : (uint32_t)pos[k]);
      }
    }
    return sorted;
  }
};

// Block 0: the sort (or the conversion of the caller's sort), then seg,
// seg_begin, meta[0] = segments, and zeros over the `done` counters of
// launch B. Blocks 1..: zeros over out.
template <int ITEMS, bool PACKED>
__global__ void __launch_bounds__(SORT_THREADS)
sort_and_zero_kernel(const void* __restrict__ ids, int ids_wide,
                     int ids_stride, const void* __restrict__ order_in,
                     int order_wide, int n,
                     int num_keys, int key_bits, int pos_bits,
                     int32_t* __restrict__ keys_sorted,
                     int32_t* __restrict__ order, int32_t* __restrict__ seg,
                     int32_t* __restrict__ seg_begin,
                     int32_t* __restrict__ meta, int32_t* __restrict__ done,
                     int num_done, void* __restrict__ out, size_t out_units,
                     int unit) {
  extern __shared__ __align__(16) unsigned char sort_smem[];
  __shared__ int tmp[33];
  const int tid = threadIdx.x;
  if (blockIdx.x > 0) {
    const size_t first = (size_t)(blockIdx.x - 1) * SORT_THREADS + tid;
    const size_t stride = (size_t)(gridDim.x - 1) * SORT_THREADS;
    if (unit == 16) {
      float4* out4 = reinterpret_cast<float4*>(out);
      const float4 zero = make_float4(0.f, 0.f, 0.f, 0.f);
      for (size_t i = first; i < out_units; i += stride) out4[i] = zero;
    } else if (unit == 4) {
      float* out1 = reinterpret_cast<float*>(out);
      for (size_t i = first; i < out_units; i += stride) out1[i] = 0.f;
    } else {
      uint16_t* out2 = reinterpret_cast<uint16_t*>(out);
      for (size_t i = first; i < out_units; i += stride) out2[i] = 0;
    }
    return;
  }
  for (int i = tid; i < num_done; i += SORT_THREADS) done[i] = 0;
  SortedKeys key_at;
  if constexpr (ITEMS > 0) {
    key_at = {BlockSort<ITEMS, PACKED>::run(ids, ids_wide != 0, ids_stride, n,
                                            num_keys, key_bits, pos_bits,
                                            sort_smem, keys_sorted, order),
              true};
  } else {
    for (int i = tid; i < n; i += SORT_THREADS) {
      keys_sorted[i] =
          key_of(ids, ids_wide != 0, (size_t)i * ids_stride, num_keys);
      order[i] = (int32_t)index_at(order_in, order_wide != 0, i);
    }
    key_at = {reinterpret_cast<const uint32_t*>(keys_sorted), false};
  }
  __syncthreads();  // the sorted keys are in place
  // 1,024 positions at a time: mark where a run of equal keys starts, scan
  // the marks over the block; neighbouring threads write neighbouring words
  int segments = 0;
  for (int base = 0; base < n; base += SORT_THREADS) {
    const int i = base + tid;
    const int starts =
        i < n && (i == 0 || key_at(i) != key_at(i - 1)) ? 1 : 0;
    int total;
    const int before = block_exclusive_scan(starts, tmp, total);
    if (i < n) {
      const int s = segments + before + starts - 1;
      seg[i] = s;
      if (starts) seg_begin[s] = i;
    }
    segments += total;
  }
  if (tid == 0) {
    seg_begin[segments] = n;
    meta[0] = segments;
  }
}

__device__ __forceinline__ float load_global(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float4 load_global(const float4* p) {
  return __ldcg(p);
}

// Blocks [0, num_chunks) x slabs: the two-level sums. Blocks past
// num_chunks (by segment only): zeros over the rows past the last segment.
// Dv is the row length in units of V; a thread owns one column of V.
template <typename V, typename T>
__global__ void __launch_bounds__(MAX_THREADS_B)
segment_sums_kernel(const int32_t* __restrict__ keys,
                    const int32_t* __restrict__ seg,
                    const int32_t* __restrict__ seg_begin,
                    const int32_t* __restrict__ order,
                    const int32_t* __restrict__ meta,
                    const T* __restrict__ upd, int n, int Dv, int out_rows,
                    int num_chunks, int by_segment, T* __restrict__ out,
                    V* partial, int32_t* done) {
  using E = Elem<V, T>;
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const int col = blockIdx.y * blockDim.x + tid;
  const bool active = col < Dv;
  const V zero = vzero((const V*)nullptr);

  if (b >= num_chunks) {
    const int step = gridDim.x - num_chunks;
    if (active) {
      for (int row = meta[0] + (b - num_chunks); row < out_rows; row += step)
        E::store(out, (size_t)row * Dv + col, zero);
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
    for (int i0 = 0; i0 < len; i0 += AHEAD) {
      V v[AHEAD];
#pragma unroll
      for (int u = 0; u < AHEAD; ++u)
        if (i0 + u < len) v[u] = E::load(upd, (size_t)s_src[i0 + u] * Dv + col);
#pragma unroll
      for (int u = 0; u < AHEAD; ++u) {
        const int i = i0 + u;
        if (i < len) {
          vadd(acc, v[u]);
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

int bits_of(int value) {  // bits needed to hold 0..value
  int bits = 1;
  while ((value >> bits) != 0) ++bits;
  return bits;
}

int threads_for(int Dv) {
  const int t = (Dv + 31) / 32 * 32;
  return t < 32 ? 32 : (t > MAX_THREADS_B ? MAX_THREADS_B : t);
}

template <typename V, typename T>
int launch_sums(const int32_t* keys, const int32_t* seg,
                const int32_t* seg_begin, const int32_t* order,
                const int32_t* meta, const T* upd, int n, int Dv,
                int out_rows, int num_chunks, int by_segment, T* out,
                float* partial, int32_t* done, cudaStream_t stream) {
  const int threads = threads_for(Dv);
  const int slabs = (Dv + threads - 1) / threads;
  const int tail = by_segment ? (out_rows < 128 ? out_rows : 128) : 0;
  dim3 grid(num_chunks + tail, slabs);
  segment_sums_kernel<V, T><<<grid, threads, 0, stream>>>(
      keys, seg, seg_begin, order, meta, upd, n, Dv, out_rows,
      num_chunks, by_segment, out, (V*)partial, done);
  return (int)cudaGetLastError();
}

template <int ITEMS, bool PACKED, typename... Args>
cudaError_t launch_sort_as(unsigned grid, size_t smem, cudaStream_t stream,
                           Args... args) {
  // static shared memory counts against the 48 KB that need no opt-in
  if (smem > 40 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        sort_and_zero_kernel<ITEMS, PACKED>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (err != cudaSuccess) return err;
  }
  sort_and_zero_kernel<ITEMS, PACKED>
      <<<grid, SORT_THREADS, smem, stream>>>(args...);
  return cudaGetLastError();
}

template <int ITEMS, typename... Args>
cudaError_t launch_sort(bool packed, unsigned grid, cudaStream_t stream,
                        Args... args) {
  if (packed) {
    return launch_sort_as<ITEMS, true>(grid, BlockSort<ITEMS, true>::BYTES,
                                       stream, args...);
  }
  return launch_sort_as<ITEMS, false>(grid, BlockSort<ITEMS, false>::BYTES,
                                      stream, args...);
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
  int32_t* keys_sorted = work;
  int32_t* order = work + n;
  int32_t* seg = work + 2 * (size_t)n;
  int32_t* seg_begin = work + 3 * (size_t)n;
  int32_t* meta = work + 4 * (size_t)n + 1;
  int32_t* done = meta + 1;
  // four columns a thread: 16-byte rows of upd and out in float32, 8-byte
  // ones in bfloat16
  const bool vec = D % 4 == 0 && aligned16(partial) &&
                   ((uintptr_t)upd % (4 * sizeof(T))) == 0 &&
                   ((uintptr_t)out % (4 * sizeof(T))) == 0;
  const int Dv = vec ? D / 4 : D;
  const int threads = threads_for(Dv);
  const int num_done = num_chunks * ((Dv + threads - 1) / threads);

  if (phases & 1) {
    // of the current device, asked at every call: a process may hold cards
    // of different sizes
    int device = 0, sm_count = 0;
    cudaGetDevice(&device);
    cudaDeviceGetAttribute(&sm_count, cudaDevAttrMultiProcessorCount, device);
    if (sm_count <= 0) sm_count = 1;
    size_t zero_blocks = 0;
    const size_t out_floats = (size_t)out_rows * D * sizeof(T) / 4;
    const size_t out_bytes = (size_t)out_rows * D * sizeof(T);
    // zeros in 16-byte stores where the bytes allow, else one element each
    const int unit = out_bytes % 16 == 0 && aligned16(out) ? 16 : (int)sizeof(T);
    const size_t out_units = out_bytes / unit;
    if (!by_segment) {
      const size_t per_block = (size_t)SORT_THREADS * (vec ? 16 : 4);
      zero_blocks = (out_floats + per_block - 1) / per_block;
      if (zero_blocks > (size_t)2 * sm_count) zero_blocks = 2 * sm_count;
    }
    const unsigned grid = 1 + (unsigned)zero_blocks;
    const int key_bits = bits_of(num_keys);
    const int pos_bits = bits_of(n > 1 ? n - 1 : 1);
    const bool packed = key_bits + pos_bits <= 32;
#define KGE_SORT(ITEMS)                                                       \
  launch_sort<ITEMS>(packed, grid, s, ids, ids_wide, ids_stride, order_in,    \
                     order_wide, n, num_keys, key_bits, pos_bits, keys_sorted, \
                     order, seg, seg_begin, meta, done, num_done, (void*)out, \
                     out_units, unit)
    // the smallest sort that holds n: its time goes by its size, not by n
    cudaError_t err =
        order_in != nullptr
            ? launch_sort_as<0, false>(grid, 0, s, ids, ids_wide, ids_stride,
                                       order_in, order_wide, n, num_keys, key_bits,
                                       pos_bits, keys_sorted, order, seg,
                                       seg_begin, meta, done, num_done,
                                       (void*)out, out_units, unit)
        : n <= SORT_THREADS      ? KGE_SORT(1)
        : n <= 4 * SORT_THREADS  ? KGE_SORT(4)
        : n <= 8 * SORT_THREADS  ? KGE_SORT(8)
        : n <= 12 * SORT_THREADS ? KGE_SORT(12)
                                 : KGE_SORT(MAX_ITEMS);
#undef KGE_SORT
    if (err != cudaSuccess) return (int)err;
  }
  if ((phases & 2) && num_chunks > 0) {
    if (vec) {
      return launch_sums<float4, T>(keys_sorted, seg, seg_begin, order, meta,
                                    upd, n, Dv, out_rows, num_chunks,
                                    by_segment, out, partial, done, s);
    }
    return launch_sums<float, T>(keys_sorted, seg, seg_begin, order, meta, upd,
                                 n, Dv, out_rows, num_chunks, by_segment, out,
                                 partial, done, s);
  }
  return 0;
}

extern "C" {

// Positions the in-kernel sort takes; above it the caller passes a sort.
int scatter_add_sort_limit() { return SORT_LIMIT; }

// Sorted positions per block of launch B: the scratch `partial` holds
// [ceil(n / chunk), 2, D] floats.
int scatter_add_chunk() { return CHUNK; }

// int32 words of the scratch `work`: keys_sorted [n], order [n], seg [n],
// seg_begin [n + 1], meta [1], then launch B's counters.
int scatter_add_work_ints(int n, int D) {
  const int num_chunks = (n + CHUNK - 1) / CHUNK;
  const int threads = threads_for(D);
  return 4 * n + 2 + num_chunks * ((D + threads - 1) / threads);
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

}  // extern "C"
