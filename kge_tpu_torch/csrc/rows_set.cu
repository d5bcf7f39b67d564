// In-place row writes into an embedding table, for Hopper.
//
// Replaces the TPU kernel kge_tpu/ops/pallas_ops.py rows_set (body
// _rows_set_kernel, per-row DMAs into the aliased table): it writes
//   table[ids[i]] = rows[i]  for i in [0, m)
// on the table's own storage. The table is never copied; that is the
// kernel's point, since the row-sparse optimizer step touches a few
// thousand rows of a table that may hold gigabytes.
//
// Duplicate ids must carry identical rows (the row-sparse update computes
// one value per distinct row and repeats it), so writers of one row race
// only over equal bytes and the result does not depend on their order.
//
// Bound: bytes, m * D floats read and as many written, no arithmetic. What
// this version does about it: one warp per row and 16-byte loads and stores
// when D is a multiple of 4 (a 2 KiB row at D = 512 is four per lane),
// scalar otherwise; 8 rows per block so that the grid covers every SM.
// Ids outside the table are skipped.
//
// bfloat16 and float16 tables (parallel.param_dtype: bfloat16 or float16)
// take rows_set_launch_bf16 and rows_set_launch_f16: the same copy of 2-byte
// elements, 16 bytes (8 elements) at a time when D is a multiple of 8, else
// one element at a time. Nothing is converted, so the write is exact.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

template <typename V>
__global__ void rows_set_kernel(V* __restrict__ table,
                                const int64_t* __restrict__ ids,
                                const V* __restrict__ rows, int m, int Dv,
                                int64_t num_rows) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int i = blockIdx.x * ROWS_PER_BLOCK + warp;
  if (i >= m) return;
  const int64_t row = ids[i];
  if (row < 0 || row >= num_rows) return;
  const V* src = rows + (size_t)i * Dv;
  V* dst = table + (size_t)row * Dv;
  for (int col = lane; col < Dv; col += 32) dst[col] = src[col];
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

// A table of 2-byte elements (bfloat16 or float16), copied as raw bits.
int rows_set_launch_2byte(uint16_t* table, const int64_t* ids,
                          const uint16_t* rows, int m, int D,
                          long long num_rows, void* stream) {
  if (m <= 0 || D <= 0) return 0;
  const int blocks = (m + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  if (D % 8 == 0 && aligned16(table) && aligned16(rows)) {
    rows_set_kernel<uint4><<<blocks, THREADS, 0, s>>>(
        (uint4*)table, ids, (const uint4*)rows, m, D / 8, (int64_t)num_rows);
  } else {
    rows_set_kernel<uint16_t><<<blocks, THREADS, 0, s>>>(
        table, ids, rows, m, D, (int64_t)num_rows);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok).
// table [num_rows, D] is written in place, ids [m], rows [m, D].
int rows_set_launch(float* table, const int64_t* ids, const float* rows,
                    int m, int D, long long num_rows, void* stream) {
  if (m <= 0 || D <= 0) return 0;
  const int blocks = (m + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  cudaStream_t s = (cudaStream_t)stream;
  if (D % 4 == 0 && aligned16(table) && aligned16(rows)) {
    rows_set_kernel<float4><<<blocks, THREADS, 0, s>>>(
        (float4*)table, ids, (const float4*)rows, m, D / 4,
        (int64_t)num_rows);
  } else {
    rows_set_kernel<float><<<blocks, THREADS, 0, s>>>(table, ids, rows, m, D,
                                                      (int64_t)num_rows);
  }
  return (int)cudaGetLastError();
}

int rows_set_launch_bf16(uint16_t* table, const int64_t* ids,
                         const uint16_t* rows, int m, int D,
                         long long num_rows, void* stream) {
  return rows_set_launch_2byte(table, ids, rows, m, D, num_rows, stream);
}

int rows_set_launch_f16(uint16_t* table, const int64_t* ids,
                        const uint16_t* rows, int m, int D,
                        long long num_rows, void* stream) {
  return rows_set_launch_2byte(table, ids, rows, m, D, num_rows, stream);
}

}  // extern "C"
