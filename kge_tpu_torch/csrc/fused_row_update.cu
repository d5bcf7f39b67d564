// One-pass optimizer step of a whole embedding table from row gradients,
// for Hopper.
//
// Replaces the TPU kernel kge_tpu/ops/pallas_ops.py fused_sorted_update
// (body _fused_update_kernel). With g the dense gradient that the row
// gradients would scatter into,
//   g = zeros[R, D];  g[ids[p]] += upd[p]
// it applies an elementwise optimizer rule to EVERY row of the table,
//   param, states = rule(g, param, states)
// in place on the parameter's and the states' own storage, without ever
// holding g: rows that no id names take g = 0, so that Adam's moments decay
// and weight decay applies to them exactly as on the dense step.
//
// The TPU kernel builds each table tile's gradient with one-hot matmuls over
// the tile's range of the sorted updates (with a 3-way bf16 split to reach
// f32 on the MXU). Neither is carried over. The caller sorts the ids and
// reduces duplicates with the scatter kernel (scatter_add_sorted.cu) into
// one gradient row per segment of equal ids:
//   ids  [n] sorted ascending (int32, as the scatter kernel's sort gives),
//   seg  [n] the segment number of each sorted position (int32),
//   gsum [>= number of segments, D] the summed gradient of each segment.
// Here one warp owns one table row. It binary-searches ids for its row (all
// lanes read the same words, which stay in cache: 40 KiB at n = 10,240),
// reads the segment's gradient row or takes zero, and applies the rule to
// the row of param and of every state. No atomics and one owner per element:
// two launches from the same state give the same bits. Ids outside the
// table match no row and are skipped.
//
// Bound: bytes. Every element of param and of each state is read once and
// written once (Adam at [200,000, 1,024]: 6 x 819 MB); the arithmetic is a
// dozen operations per element. What this version does about it: 16-byte
// loads and stores when D is a multiple of 4 (scalar otherwise), nothing is
// read twice, and 8 rows per block so that the grid covers every SM. What it
// does not do yet: no cp.async or TMA staging, no streaming cache hints.
//
// The rules are kge_tpu's (ops/optim.py _RULES), term for term and in the
// same order of operations as the plain PyTorch versions beside the wrapper,
// so that both round alike up to the compiler's fused multiply-adds. Every
// scalar that the plain version computes on the host (1 - beta, the bias
// corrections, the decayed learning rate) arrives computed the same way.

// bfloat16 tables (parallel.param_dtype: bfloat16; fused_row_update_launch_
// bf16): param, states and gsum are bfloat16 (gsum: the scatter kernel's
// float32 segment sums, rounded once). The rules are the *B structs below:
// kge_tpu's rules as its fused kernel would run them on bfloat16 tiles,
// each operation rounded where JAX rounds it. An operation between bfloat16
// values and Python constants (weakly typed: the constant is rounded to
// bfloat16 first) is rounded to bfloat16; the learning rate and the step
// are float32 arrays in that kernel, so a term with either of them, Adam's
// bias-corrected moments included, is float32, unrounded. The new parameter
// is rounded once when it is stored, as the kernel's bfloat16 output tile
// would round it; the states are bfloat16 already. Loads and stores of 4
// elements are 8 bytes. Half the bytes of the float32 path move.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int THREADS = 256;
constexpr int ROWS_PER_BLOCK = THREADS / 32;

// Hyperparameters of one call; which fields a rule reads is noted on it.
struct Hyper {
  float lr;       // learning rate (adagrad: already divided by the lr decay)
  float wd;       // weight decay; 0 = none
  float eps;
  float b1, omb1;  // beta1 (rmsprop: alpha, adadelta: rho) and 1 - it
  float b2, omb2;  // beta2 and 1 - beta2
  float c1, c2;    // bias corrections 1 - beta^t; adamax: -lr / c1 in c1
  float momentum;  // sgd, rmsprop
  float omd;       // sgd: 1 - dampening
  float lrwd;      // adamw: lr * weight_decay
  int flags;       // FLAG_* bits
};

constexpr int FLAG_NESTEROV = 1;    // sgd
constexpr int FLAG_FIRST_STEP = 2;  // sgd: step 0 sets the momentum buffer
constexpr int FLAG_CENTERED = 4;    // rmsprop
constexpr int FLAG_DECOUPLED = 8;   // adam: AdamW's decoupled weight decay

__device__ __forceinline__ float with_wd(float g, float p, const Hyper& h) {
  return h.wd != 0.f ? g + h.wd * p : g;
}

// Every rule: apply(g, p, s, h) updates the parameter element p and the
// state elements s[0..NSTATE) (states in sorted key order).

struct Adagrad {  // states: sum
  static constexpr int NSTATE = 1;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd(g, p, h);
    const float sum = s[0] + g * g;
    p = p + (-h.lr * g) / (sqrtf(sum) + h.eps);
    s[0] = sum;
  }
};

struct Adam {  // states: m, v; FLAG_DECOUPLED selects AdamW
  static constexpr int NSTATE = 2;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    const bool decoupled = h.flags & FLAG_DECOUPLED;
    if (!decoupled) g = with_wd(g, p, h);
    const float m = h.b1 * s[0] + h.omb1 * g;
    const float v = h.b2 * s[1] + (h.omb2 * g) * g;
    const float m_hat = m / h.c1;
    const float v_hat = v / h.c2;
    float delta = (-h.lr * m_hat) / (sqrtf(v_hat) + h.eps);
    if (decoupled && h.wd != 0.f) delta = delta - h.lrwd * p;
    p = p + delta;
    s[0] = m;
    s[1] = v;
  }
};

struct Adamax {  // states: m, u; c1 holds -lr / (1 - beta1^t)
  static constexpr int NSTATE = 2;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd(g, p, h);
    const float m = h.b1 * s[0] + h.omb1 * g;
    const float u = fmaxf(h.b2 * s[1], fabsf(g) + h.eps);
    p = p + (h.c1 * m) / u;
    s[0] = m;
    s[1] = u;
  }
};

struct SgdPlain {  // no state
  static constexpr int NSTATE = 0;
  __device__ static void apply(float g, float& p, float*, const Hyper& h) {
    g = with_wd(g, p, h);
    p = p + (-h.lr * g);
  }
};

struct SgdMomentum {  // states: momentum
  static constexpr int NSTATE = 1;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd(g, p, h);
    const float buf = (h.flags & FLAG_FIRST_STEP)
                          ? g
                          : h.momentum * s[0] + h.omd * g;
    const float d = (h.flags & FLAG_NESTEROV) ? g + h.momentum * buf : buf;
    p = p + (-h.lr * d);
    s[0] = buf;
  }
};

// RMSprop's states in sorted key order are the present ones of
// (avg, momentum, sq): avg with `centered`, momentum with a momentum.
template <bool CENTERED, bool MOMENTUM>
struct RmsProp {
  static constexpr int NSTATE = 1 + (CENTERED ? 1 : 0) + (MOMENTUM ? 1 : 0);
  static constexpr int AVG = 0;
  static constexpr int MOM = CENTERED ? 1 : 0;
  static constexpr int SQ = NSTATE - 1;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd(g, p, h);
    const float sq = h.b1 * s[SQ] + (h.omb1 * g) * g;
    float denom;
    if (CENTERED) {
      const float avg = h.b1 * s[AVG] + h.omb1 * g;
      denom = sqrtf(sq - avg * avg + h.eps);
      s[AVG] = avg;
    } else {
      denom = sqrtf(sq) + h.eps;
    }
    s[SQ] = sq;
    if (MOMENTUM) {
      const float buf = h.momentum * s[MOM] + g / denom;
      s[MOM] = buf;
      p = p + (-h.lr * buf);
    } else {
      p = p + (-h.lr * g) / denom;
    }
  }
};

using RmsPlain = RmsProp<false, false>;
using RmsMomentum = RmsProp<false, true>;
using RmsCentered = RmsProp<true, false>;
using RmsCenteredMomentum = RmsProp<true, true>;

struct Adadelta {  // states: acc, sq
  static constexpr int NSTATE = 2;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd(g, p, h);
    const float sq = h.b1 * s[1] + (h.omb1 * g) * g;
    const float delta = sqrtf(s[0] + h.eps) / sqrtf(sq + h.eps) * g;
    s[0] = h.b1 * s[0] + (h.omb1 * delta) * delta;
    s[1] = sq;
    p = p + (-h.lr * delta);
  }
};

// first position in ids[0, n) whose id is >= value (n when there is none)
// -- the bfloat16 rules ---------------------------------------------------
//
// R(x): x rounded to bfloat16 (round to nearest even), as a float. A
// bfloat16 operation is an exact float32 operation on bfloat16 values
// rounded by R, as XLA computes it; W(c) is a weakly typed constant.

__device__ __forceinline__ float R(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
__device__ __forceinline__ float W(float c) { return R(c); }
__device__ __forceinline__ float mulb(float a, float b) {
  return R(__fmul_rn(a, b));
}
__device__ __forceinline__ float addb(float a, float b) {
  return R(__fadd_rn(a, b));
}

__device__ __forceinline__ float with_wd_b(float g, float p, const Hyper& h) {
  return h.wd != 0.f ? addb(g, mulb(W(h.wd), p)) : g;
}

struct AdagradB {
  static constexpr int NSTATE = 1;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd_b(g, p, h);
    const float sum = addb(s[0], mulb(g, g));
    const float denom = addb(R(sqrtf(sum)), W(h.eps));
    p = __fadd_rn(p, __fdiv_rn(__fmul_rn(-h.lr, g), denom));
    s[0] = sum;
  }
};

struct AdamB {  // m_hat, v_hat and the step are float32 (the step's dtype)
  static constexpr int NSTATE = 2;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    const bool decoupled = h.flags & FLAG_DECOUPLED;
    if (!decoupled) g = with_wd_b(g, p, h);
    const float m = addb(mulb(W(h.b1), s[0]), mulb(W(h.omb1), g));
    const float v = addb(mulb(W(h.b2), s[1]), mulb(mulb(W(h.omb2), g), g));
    const float m_hat = __fdiv_rn(m, h.c1);
    const float v_hat = __fdiv_rn(v, h.c2);
    float delta = __fdiv_rn(__fmul_rn(-h.lr, m_hat),
                            __fadd_rn(sqrtf(v_hat), h.eps));
    if (decoupled && h.wd != 0.f) delta = __fsub_rn(delta, __fmul_rn(h.lrwd, p));
    p = __fadd_rn(p, delta);
    s[0] = m;
    s[1] = v;
  }
};

struct AdamaxB {  // c1 holds -lr / (1 - beta1^t), a float32 term
  static constexpr int NSTATE = 2;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd_b(g, p, h);
    const float m = addb(mulb(W(h.b1), s[0]), mulb(W(h.omb1), g));
    const float u = fmaxf(mulb(W(h.b2), s[1]), addb(fabsf(g), W(h.eps)));
    p = __fadd_rn(p, __fdiv_rn(__fmul_rn(h.c1, m), u));
    s[0] = m;
    s[1] = u;
  }
};

struct SgdPlainB {
  static constexpr int NSTATE = 0;
  __device__ static void apply(float g, float& p, float*, const Hyper& h) {
    g = with_wd_b(g, p, h);
    p = __fadd_rn(p, __fmul_rn(-h.lr, g));
  }
};

struct SgdMomentumB {
  static constexpr int NSTATE = 1;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd_b(g, p, h);
    const float buf = (h.flags & FLAG_FIRST_STEP)
                          ? g
                          : addb(mulb(W(h.momentum), s[0]), mulb(W(h.omd), g));
    const float d =
        (h.flags & FLAG_NESTEROV) ? addb(g, mulb(W(h.momentum), buf)) : buf;
    p = __fadd_rn(p, __fmul_rn(-h.lr, d));
    s[0] = buf;
  }
};

template <bool CENTERED, bool MOMENTUM>
struct RmsPropB {
  static constexpr int NSTATE = 1 + (CENTERED ? 1 : 0) + (MOMENTUM ? 1 : 0);
  static constexpr int AVG = 0;
  static constexpr int MOM = CENTERED ? 1 : 0;
  static constexpr int SQ = NSTATE - 1;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd_b(g, p, h);
    const float sq = addb(mulb(W(h.b1), s[SQ]), mulb(mulb(W(h.omb1), g), g));
    float denom;
    if (CENTERED) {
      const float avg = addb(mulb(W(h.b1), s[AVG]), mulb(W(h.omb1), g));
      denom = R(sqrtf(addb(R(__fsub_rn(sq, mulb(avg, avg))), W(h.eps))));
      s[AVG] = avg;
    } else {
      denom = addb(R(sqrtf(sq)), W(h.eps));
    }
    s[SQ] = sq;
    if (MOMENTUM) {
      const float buf = addb(mulb(W(h.momentum), s[MOM]), R(__fdiv_rn(g, denom)));
      s[MOM] = buf;
      p = __fadd_rn(p, __fmul_rn(-h.lr, buf));
    } else {
      p = __fadd_rn(p, __fdiv_rn(__fmul_rn(-h.lr, g), denom));
    }
  }
};

struct AdadeltaB {  // states: acc, sq
  static constexpr int NSTATE = 2;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd_b(g, p, h);
    const float sq = addb(mulb(W(h.b1), s[1]), mulb(mulb(W(h.omb1), g), g));
    const float ratio = R(__fdiv_rn(R(sqrtf(addb(s[0], W(h.eps)))),
                                    R(sqrtf(addb(sq, W(h.eps))))));
    const float delta = mulb(ratio, g);
    s[0] = addb(mulb(W(h.b1), s[0]), mulb(mulb(W(h.omb1), delta), delta));
    s[1] = sq;
    p = __fadd_rn(p, __fmul_rn(-h.lr, delta));
  }
};

__device__ __forceinline__ int lower_bound(const int32_t* ids, int n,
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

struct States {
  float* s[3];
};

// VEC floats per access (4: 16-byte loads and stores; 1: scalar). Dv is the
// row length in units of VEC floats.
template <typename Rule, int VEC>
__global__ void fused_row_update_kernel(const int32_t* __restrict__ ids,
                                        const int32_t* __restrict__ seg,
                                        const float* __restrict__ gsum, int n,
                                        int Dv, int64_t num_rows,
                                        float* __restrict__ param,
                                        States states, Hyper h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= num_rows) return;
  const int pos = lower_bound(ids, n, row);
  const bool touched = pos < n && ids[pos] == row;
  const float* grow =
      touched ? gsum + (size_t)seg[pos] * Dv * VEC : nullptr;
  const size_t base = (size_t)row * Dv * VEC;

  for (int col = lane; col < Dv; col += 32) {
    const size_t at = base + (size_t)col * VEC;
    float g[VEC], p[VEC], s[3][VEC];
    if constexpr (VEC == 4) {
      const float4 pv = *reinterpret_cast<const float4*>(param + at);
      p[0] = pv.x, p[1] = pv.y, p[2] = pv.z, p[3] = pv.w;
      float4 gv = make_float4(0.f, 0.f, 0.f, 0.f);
      if (touched) gv = *reinterpret_cast<const float4*>(grow + col * VEC);
      g[0] = gv.x, g[1] = gv.y, g[2] = gv.z, g[3] = gv.w;
#pragma unroll
      for (int k = 0; k < Rule::NSTATE; ++k) {
        const float4 sv = *reinterpret_cast<const float4*>(states.s[k] + at);
        s[k][0] = sv.x, s[k][1] = sv.y, s[k][2] = sv.z, s[k][3] = sv.w;
      }
    } else {
      p[0] = param[at];
      g[0] = touched ? grow[col] : 0.f;
#pragma unroll
      for (int k = 0; k < Rule::NSTATE; ++k) s[k][0] = states.s[k][at];
    }
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float st[3];
#pragma unroll
      for (int k = 0; k < Rule::NSTATE; ++k) st[k] = s[k][e];
      Rule::apply(g[e], p[e], st, h);
#pragma unroll
      for (int k = 0; k < Rule::NSTATE; ++k) s[k][e] = st[k];
    }
    if constexpr (VEC == 4) {
      *reinterpret_cast<float4*>(param + at) =
          make_float4(p[0], p[1], p[2], p[3]);
#pragma unroll
      for (int k = 0; k < Rule::NSTATE; ++k) {
        *reinterpret_cast<float4*>(states.s[k] + at) =
            make_float4(s[k][0], s[k][1], s[k][2], s[k][3]);
      }
    } else {
      param[at] = p[0];
#pragma unroll
      for (int k = 0; k < Rule::NSTATE; ++k) states.s[k][at] = s[k][0];
    }
  }
}

// The bfloat16 path of fused_row_update_kernel: the same walk, elements
// widened as they load and rounded as they store (VEC = 4: 8-byte accesses).
template <int VEC>
struct Bf16Vec;
template <>
struct Bf16Vec<1> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    v[0] = __bfloat162float(*p);
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    *p = __float2bfloat16_rn(v[0]);
  }
};
template <>
struct Bf16Vec<4> {
  __device__ static void load(const __nv_bfloat16* p, float* v) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.x));
    const float2 b =
        __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&raw.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
  __device__ static void store(__nv_bfloat16* p, const float* v) {
    const __nv_bfloat162 a = __floats2bfloat162_rn(v[0], v[1]);
    const __nv_bfloat162 b = __floats2bfloat162_rn(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&a);
    raw.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

struct Bf16States {
  __nv_bfloat16* s[3];
};

template <typename Rule, int VEC>
__global__ void fused_row_update_bf16_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ seg,
    const __nv_bfloat16* __restrict__ gsum, int n, int Dv, int64_t num_rows,
    __nv_bfloat16* __restrict__ param, Bf16States states, Hyper h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= num_rows) return;
  const int pos = lower_bound(ids, n, row);
  const bool touched = pos < n && ids[pos] == row;
  const __nv_bfloat16* grow =
      touched ? gsum + (size_t)seg[pos] * Dv * VEC : nullptr;
  const size_t base = (size_t)row * Dv * VEC;
  for (int col = lane; col < Dv; col += 32) {
    const size_t at = base + (size_t)col * VEC;
    float g[VEC], p[VEC], s[3][VEC];
    Bf16Vec<VEC>::load(param + at, p);
    if (touched) {
      Bf16Vec<VEC>::load(grow + col * VEC, g);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) g[e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < Rule::NSTATE; ++k)
      Bf16Vec<VEC>::load(states.s[k] + at, s[k]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float st[3];
#pragma unroll
      for (int k = 0; k < Rule::NSTATE; ++k) st[k] = s[k][e];
      Rule::apply(g[e], p[e], st, h);
#pragma unroll
      for (int k = 0; k < Rule::NSTATE; ++k) s[k][e] = st[k];
    }
    Bf16Vec<VEC>::store(param + at, p);
#pragma unroll
    for (int k = 0; k < Rule::NSTATE; ++k)
      Bf16Vec<VEC>::store(states.s[k] + at, s[k]);
  }
}

bool aligned16(const void* p) { return ((uintptr_t)p & 15u) == 0; }

template <typename Rule>
int launch(const int32_t* ids, const int32_t* seg, const float* gsum, int n,
           int D, long long num_rows, float* param, States states, int nstate,
           const Hyper& h, cudaStream_t stream) {
  if (nstate != Rule::NSTATE) return (int)cudaErrorInvalidValue;
  const long long blocks = (num_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  bool vec = D % 4 == 0 && aligned16(param) && (n == 0 || aligned16(gsum));
  for (int k = 0; k < Rule::NSTATE; ++k) vec = vec && aligned16(states.s[k]);
  if (vec) {
    fused_row_update_kernel<Rule, 4><<<(unsigned)blocks, THREADS, 0, stream>>>(
        ids, seg, gsum, n, D / 4, (int64_t)num_rows, param, states, h);
  } else {
    fused_row_update_kernel<Rule, 1><<<(unsigned)blocks, THREADS, 0, stream>>>(
        ids, seg, gsum, n, D, (int64_t)num_rows, param, states, h);
  }
  return (int)cudaGetLastError();
}

// Rule numbers of fused_row_update_launch (and _bf16).
enum {
  RULE_ADAGRAD = 0,
  RULE_ADAM = 1,   // and AdamW with FLAG_DECOUPLED
  RULE_ADAMAX = 2,
  RULE_SGD = 3,
  RULE_RMSPROP = 4,
  RULE_ADADELTA = 5,
};

template <typename Rule>
int launch_bf16(const int32_t* ids, const int32_t* seg, const void* gsum,
                int n, int D, long long num_rows, void* param, States st,
                int nstate, const Hyper& h, cudaStream_t stream) {
  if (nstate != Rule::NSTATE) return (int)cudaErrorInvalidValue;
  const long long blocks = (num_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  auto aligned8 = [](const void* q) { return ((uintptr_t)q & 7u) == 0; };
  bool vec = D % 4 == 0 && aligned8(param) && (n == 0 || aligned8(gsum));
  Bf16States states;
  for (int k = 0; k < 3; ++k) {
    states.s[k] = reinterpret_cast<__nv_bfloat16*>(st.s[k]);
    if (k < Rule::NSTATE) vec = vec && aligned8(st.s[k]);
  }
  const auto* g = reinterpret_cast<const __nv_bfloat16*>(gsum);
  auto* p = reinterpret_cast<__nv_bfloat16*>(param);
  if (vec) {
    fused_row_update_bf16_kernel<Rule, 4><<<(unsigned)blocks, THREADS, 0, stream>>>(
        ids, seg, g, n, D / 4, (int64_t)num_rows, p, states, h);
  } else {
    fused_row_update_bf16_kernel<Rule, 1><<<(unsigned)blocks, THREADS, 0, stream>>>(
        ids, seg, g, n, D, (int64_t)num_rows, p, states, h);
  }
  return (int)cudaGetLastError();
}

// The rule's launch: BF selects the bfloat16 kernel and rules.
template <bool BF, typename Rule, typename RuleB>
int launch_as(const int32_t* ids, const int32_t* seg, const void* gsum, int n,
              int D, long long num_rows, void* param, States st, int nstate,
              const Hyper& h, cudaStream_t stream) {
  if constexpr (BF) {
    return launch_bf16<RuleB>(ids, seg, gsum, n, D, num_rows, param, st,
                              nstate, h, stream);
  } else {
    return launch<Rule>(ids, seg, (const float*)gsum, n, D, num_rows,
                        (float*)param, st, nstate, h, stream);
  }
}

template <bool BF>
int dispatch(int rule, const int32_t* ids, const int32_t* seg,
             const void* gsum, int n, int D, long long num_rows, void* param,
             States st, int nstate, const Hyper& h, int flags,
             cudaStream_t s) {
#define KGE_LAUNCH(RULE)                                                  \
  return launch_as<BF, RULE, RULE##B>(ids, seg, gsum, n, D, num_rows,     \
                                      param, st, nstate, h, s)
  switch (rule) {
    case RULE_ADAGRAD:
      KGE_LAUNCH(Adagrad);
    case RULE_ADAM:
      KGE_LAUNCH(Adam);
    case RULE_ADAMAX:
      KGE_LAUNCH(Adamax);
    case RULE_SGD:
      if (h.momentum != 0.f) KGE_LAUNCH(SgdMomentum);
      KGE_LAUNCH(SgdPlain);
    case RULE_RMSPROP: {
      const bool centered = flags & FLAG_CENTERED;
      const bool mom = h.momentum != 0.f;
      if (centered && mom) {
        return launch_as<BF, RmsProp<true, true>, RmsPropB<true, true>>(
            ids, seg, gsum, n, D, num_rows, param, st, nstate, h, s);
      }
      if (centered) {
        return launch_as<BF, RmsProp<true, false>, RmsPropB<true, false>>(
            ids, seg, gsum, n, D, num_rows, param, st, nstate, h, s);
      }
      if (mom) {
        return launch_as<BF, RmsProp<false, true>, RmsPropB<false, true>>(
            ids, seg, gsum, n, D, num_rows, param, st, nstate, h, s);
      }
      return launch_as<BF, RmsProp<false, false>, RmsPropB<false, false>>(
          ids, seg, gsum, n, D, num_rows, param, st, nstate, h, s);
    }
    case RULE_ADADELTA:
      KGE_LAUNCH(Adadelta);
  }
#undef KGE_LAUNCH
  return (int)cudaErrorInvalidValue;
}

Hyper hyper_of(const float* hyper, int flags) {
  Hyper h;
  h.lr = hyper[0], h.wd = hyper[1], h.eps = hyper[2];
  h.b1 = hyper[3], h.omb1 = hyper[4], h.b2 = hyper[5], h.omb2 = hyper[6];
  h.c1 = hyper[7], h.c2 = hyper[8];
  h.momentum = hyper[9], h.omd = hyper[10], h.lrwd = hyper[11];
  h.flags = flags;
  return h;
}

}  // namespace

extern "C" {

// Launches on `stream`; returns the CUDA error code of the launch (0 = ok).
// ids [n] sorted ascending, seg [n], gsum [segments, D]; param [num_rows, D]
// and the nstate states (sorted key order, each [num_rows, D]) are updated
// in place. hyper: the 12 floats of Hyper in its order.
int fused_row_update_launch(int rule, const int32_t* ids, const int32_t* seg,
                            const float* gsum, int n, int D,
                            long long num_rows, float* param, float* s0,
                            float* s1, float* s2, int nstate,
                            const float* hyper, int flags, void* stream) {
  if (D <= 0 || num_rows <= 0) return 0;
  States st;
  st.s[0] = s0, st.s[1] = s1, st.s[2] = s2;
  return dispatch<false>(rule, ids, seg, gsum, n, D, num_rows, param, st,
                         nstate, hyper_of(hyper, flags), flags,
                         (cudaStream_t)stream);
}

// The same on a bfloat16 table: param, the states and gsum are bfloat16
// (the pointers are passed as they are), with the *B rules.
int fused_row_update_launch_bf16(int rule, const int32_t* ids,
                                 const int32_t* seg, const void* gsum, int n,
                                 int D, long long num_rows, void* param,
                                 void* s0, void* s1, void* s2, int nstate,
                                 const float* hyper, int flags, void* stream) {
  if (D <= 0 || num_rows <= 0) return 0;
  States st;
  st.s[0] = (float*)s0, st.s[1] = (float*)s1, st.s[2] = (float*)s2;
  return dispatch<true>(rule, ids, seg, gsum, n, D, num_rows, param, st,
                        nstate, hyper_of(hyper, flags), flags,
                        (cudaStream_t)stream);
}

}  // extern "C"
