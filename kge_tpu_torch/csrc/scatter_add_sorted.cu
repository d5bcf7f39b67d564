// Deterministic scatter-add of sorted row updates into a dense table
// gradient, for Hopper.
//
// Replaces the TPU kernel kge_tpu/ops/pallas_ops.py sorted_scatter_add (body
// _scatter_kernel), the backward of every embedding lookup
// (_pallas_gather_bwd). It computes
//   out = zeros[num_rows, D];  out[ids[p]] += upd[order[p]]  for p in [0, n)
// where ids is sorted ascending (the caller sorts, as the TPU wrapper does)
// and order[p] is the row of upd that sorted position p came from, so the
// permuted updates are never materialized. The whole of out is written
// here, zeros included.
//
// The TPU kernel sums a row tile's update range with one-hot matmuls and a
// 3-way bf16 split to reach f32 accuracy on the MXU. Neither is carried
// over: these are plain f32 adds.
//
// Determinism: every output row is summed by one owner in ascending sorted
// position, with no atomics, so two launches on the same input give the same
// bits. Segment lengths are wildly skewed (a popular relation owns
// thousands of the 8192 updates of a batch, most entities own one to three,
// mini-table ids are an arange), so a row is not summed by one block from
// end to end. The sum has two fixed-order levels:
//
//  1. The sorted positions are cut into chunks of CHUNK = 32. One block per
//     chunk walks its positions in order and sums each piece (a maximal run
//     of one id inside the chunk). A piece that is a whole segment is
//     written to out. A piece cut by a chunk edge goes to a scratch slot of
//     its chunk: slot 0 for the chunk's first piece, slot 1 for its last.
//  2. One block per chunk looks whether a cut segment starts in its chunk.
//     If so it owns that row: it adds the scratch slots of the chunks the
//     segment covers, in ascending chunk order, and writes the row.
//
// So a segment of length L costs ceil(L / 32) blocks of at most 32 adds and
// one block of ceil(L / 32) adds. Rows that no id names are zero-filled by
// extra blocks of the first launch (a lane searches ids for its row; a warp
// writes the zeros).
//
// Bound: bytes. Each update row is read once and each output row written
// once; there is one add per element read. At n = 8192, D = 512 and 14,541
// rows that is 16.8 MB read and 29.8 MB written. What this version does
// about it: 16-byte loads and stores when D is a multiple of 4 (scalar
// otherwise), one block per 64 KiB of updates so that many SMs stream at
// once, and nothing is read twice except the small scratch. What it does not
// do yet: it does not stage rows through shared memory with cp.async or
// TMA, and the level-2 owner of a very long segment is one block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHUNK = 32;        // sorted positions per level-1 block
constexpr int THREADS = 128;     // threads per block
constexpr int ZROWS_PER_WARP = 8;
constexpr int ZROWS = (THREADS / 32) * ZROWS_PER_WARP;  // rows per zero block

__device__ __forceinline__ float vzero(const float*) { return 0.f; }
__device__ __forceinline__ float4 vzero(const float4*) {
  return make_float4(0.f, 0.f, 0.f, 0.f);
}
__device__ __forceinline__ void vadd(float& a, const float b) { a += b; }
__device__ __forceinline__ void vadd(float4& a, const float4 b) {
  a.x += b.x;
  a.y += b.y;
  a.z += b.z;
  a.w += b.w;
}

// first position in ids[0, n) whose id is >= value (n when there is none)
__device__ __forceinline__ int lower_bound(const int64_t* ids, int n,
                                           int64_t value) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (ids[mid] < value) {
      lo = mid + 1;
    } else {
      hi = mid;
    }
  }
  return lo;
}

// Blocks [0, num_chunks): level 1. Blocks from num_chunks on: zero-fill of
// the rows that ids does not name. Dv is the row length in units of V.
template <typename V>
__global__ void chunk_sums_kernel(const int64_t* __restrict__ ids,
                                  const int64_t* __restrict__ order,
                                  const V* __restrict__ upd, int n, int Dv,
                                  int num_rows, int num_chunks,
                                  V* __restrict__ out,
                                  V* __restrict__ partial) {
  const int tid = threadIdx.x;
  const int b = blockIdx.x;
  const V zero = vzero((const V*)nullptr);

  if (b >= num_chunks) {
    const int warp = tid >> 5, lane = tid & 31;
    const int row0 = (b - num_chunks) * ZROWS + warp * ZROWS_PER_WARP;
    bool absent = false;
    if (lane < ZROWS_PER_WARP && row0 + lane < num_rows) {
      const int64_t row = row0 + lane;
      const int pos = lower_bound(ids, n, row);
      absent = !(pos < n && ids[pos] == row);
    }
    const unsigned mask = __ballot_sync(0xffffffffu, absent);
    for (int k = 0; k < ZROWS_PER_WARP; ++k) {
      if (mask & (1u << k)) {
        V* dst = out + (size_t)(row0 + k) * Dv;
        for (int col = lane; col < Dv; col += 32) dst[col] = zero;
      }
    }
    return;
  }

  __shared__ int64_t s_id[CHUNK];
  __shared__ int64_t s_src[CHUNK];
  const int p0 = b * CHUNK;
  const int p1 = min(p0 + CHUNK, n);
  const int len = p1 - p0;
  if (tid < len) {
    s_id[tid] = ids[p0 + tid];
    s_src[tid] = order[p0 + tid];
  }
  // does the chunk's first piece start its segment, its last piece end it?
  const bool starts = (p0 == 0) || (ids[p0 - 1] != ids[p0]);
  const bool ends = (p1 == n) || (ids[p1] != ids[p1 - 1]);
  __syncthreads();

  for (int col = tid; col < Dv; col += THREADS) {
    V acc = zero;
    int piece_start = 0;
    for (int i = 0; i < len; ++i) {
      vadd(acc, upd[(size_t)s_src[i] * Dv + col]);
      if (i + 1 == len || s_id[i + 1] != s_id[i]) {
        const int64_t row = s_id[i];
        const bool whole =
            (piece_start > 0 || starts) && (i + 1 < len || ends);
        if (row >= 0 && row < num_rows) {
          if (whole) {
            out[(size_t)row * Dv + col] = acc;
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

// Level 2: the block of the chunk in which a cut segment starts sums the
// segment's scratch slots in ascending chunk order.
template <typename V>
__global__ void combine_kernel(const int64_t* __restrict__ ids, int n, int Dv,
                               int num_rows, const V* __restrict__ partial,
                               V* __restrict__ out) {
  const int b = blockIdx.x;
  const int p0 = b * CHUNK;
  const int p1 = p0 + CHUNK;
  if (p1 >= n) return;                 // nothing follows this chunk
  const int64_t row = ids[p1 - 1];
  if (ids[p1] != row) return;          // the last piece ends in this chunk
  const int seg_start = lower_bound(ids, n, row);
  if (seg_start < p0) return;          // an earlier chunk owns the row
  if (row < 0 || row >= num_rows) return;
  const int seg_end = lower_bound(ids, n, row + 1);
  const int last = (seg_end - 1) / CHUNK;
  const int slot = seg_start > p0 ? 1 : 0;
  for (int col = threadIdx.x; col < Dv; col += THREADS) {
    V acc = partial[((size_t)b * 2 + slot) * Dv + col];
    for (int c = b + 1; c <= last; ++c) {
      vadd(acc, partial[(size_t)c * 2 * Dv + col]);
    }
    out[(size_t)row * Dv + col] = acc;
  }
}

template <typename V>
int launch(const int64_t* ids, const int64_t* order, const float* upd, int n,
           int Dv, int num_rows, float* out, float* partial,
           cudaStream_t stream) {
  const int num_chunks = (n + CHUNK - 1) / CHUNK;
  const int zero_blocks = (num_rows + ZROWS - 1) / ZROWS;
  if (num_chunks + zero_blocks == 0) return 0;
  chunk_sums_kernel<V><<<num_chunks + zero_blocks, THREADS, 0, stream>>>(
      ids, order, (const V*)upd, n, Dv, num_rows, num_chunks, (V*)out,
      (V*)partial);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  if (num_chunks > 1) {
    combine_kernel<V><<<num_chunks, THREADS, 0, stream>>>(
        ids, n, Dv, num_rows, (const V*)partial, (V*)out);
    err = cudaGetLastError();
  }
  return (int)err;
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

}  // namespace

extern "C" {

// Sorted positions per level-1 block: the caller sizes the scratch as
// [ceil(n / chunk), 2, D] floats.
int scatter_add_sorted_chunk() { return CHUNK; }

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok).
// ids [n] sorted ascending, order [n] rows of upd, upd [n, D], out
// [num_rows, D] (every element is written), partial: the scratch above.
int scatter_add_sorted_launch(const int64_t* ids, const int64_t* order,
                              const float* upd, int n, int D, int num_rows,
                              float* out, float* partial, void* stream) {
  if (D <= 0 || num_rows <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  if (D % 4 == 0 && aligned16(upd) && aligned16(out) && aligned16(partial)) {
    return launch<float4>(ids, order, upd, n, D / 4, num_rows, out, partial,
                          s);
  }
  return launch<float>(ids, order, upd, n, D, num_rows, out, partial, s);
}

}  // extern "C"
