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

// float16 tables (parallel.param_dtype: float16; fused_row_update_launch_
// f16): the same rules and the same kernel, templated on the element type E,
// with R rounding to float16 (__float2half_rn, to nearest even, subnormals
// included). The product of two float16 values is exact in float32, and a
// float32 sum, quotient or square root of float16 values rounded to float16
// is the operation rounded once (24 >= 2 x 11 + 2), as for bfloat16. Weakly
// typed constants round to float16 first: Adagrad's eps 1e-10 becomes 0, so
// a K4 Adagrad step from a zero accumulator computes 0/0 on untouched
// entries, as kge_tpu's rule does; Adam's eps meets the float32 v_hat and
// stays 1e-8. A sum past 65,504 stores +-inf.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
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

// -- the rules on 16-bit tables -------------------------------------------
//
// R<E>(x): x rounded to E (bfloat16 or float16; round to nearest even), as
// a float. An operation on E values is an exact float32 operation on E
// values rounded by R, as XLA computes it; W(c) is a weakly typed constant.

using bf16 = __nv_bfloat16;

template <typename E>
__device__ __forceinline__ float R(float x);
template <>
__device__ __forceinline__ float R<bf16>(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}
template <>
__device__ __forceinline__ float R<__half>(float x) {
  return __half2float(__float2half_rn(x));
}
template <typename E>
__device__ __forceinline__ float W(float c) { return R<E>(c); }
template <typename E>
__device__ __forceinline__ float mulb(float a, float b) {
  return R<E>(__fmul_rn(a, b));
}
template <typename E>
__device__ __forceinline__ float addb(float a, float b) {
  return R<E>(__fadd_rn(a, b));
}

template <typename E>
__device__ __forceinline__ float with_wd_b(float g, float p, const Hyper& h) {
  return h.wd != 0.f ? addb<E>(g, mulb<E>(W<E>(h.wd), p)) : g;
}

template <typename E>
struct AdagradB {
  static constexpr int NSTATE = 1;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd_b<E>(g, p, h);
    const float sum = addb<E>(s[0], mulb<E>(g, g));
    const float denom = addb<E>(R<E>(sqrtf(sum)), W<E>(h.eps));
    p = __fadd_rn(p, __fdiv_rn(__fmul_rn(-h.lr, g), denom));
    s[0] = sum;
  }
};

template <typename E>
struct AdamB {  // m_hat, v_hat and the step are float32 (the step's dtype)
  static constexpr int NSTATE = 2;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    const bool decoupled = h.flags & FLAG_DECOUPLED;
    if (!decoupled) g = with_wd_b<E>(g, p, h);
    const float m = addb<E>(mulb<E>(W<E>(h.b1), s[0]), mulb<E>(W<E>(h.omb1), g));
    const float v =
        addb<E>(mulb<E>(W<E>(h.b2), s[1]), mulb<E>(mulb<E>(W<E>(h.omb2), g), g));
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

template <typename E>
struct AdamaxB {  // c1 holds -lr / (1 - beta1^t), a float32 term
  static constexpr int NSTATE = 2;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd_b<E>(g, p, h);
    const float m = addb<E>(mulb<E>(W<E>(h.b1), s[0]), mulb<E>(W<E>(h.omb1), g));
    const float u =
        fmaxf(mulb<E>(W<E>(h.b2), s[1]), addb<E>(fabsf(g), W<E>(h.eps)));
    p = __fadd_rn(p, __fdiv_rn(__fmul_rn(h.c1, m), u));
    s[0] = m;
    s[1] = u;
  }
};

template <typename E>
struct SgdPlainB {
  static constexpr int NSTATE = 0;
  __device__ static void apply(float g, float& p, float*, const Hyper& h) {
    g = with_wd_b<E>(g, p, h);
    p = __fadd_rn(p, __fmul_rn(-h.lr, g));
  }
};

template <typename E>
struct SgdMomentumB {
  static constexpr int NSTATE = 1;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd_b<E>(g, p, h);
    const float buf =
        (h.flags & FLAG_FIRST_STEP)
            ? g
            : addb<E>(mulb<E>(W<E>(h.momentum), s[0]), mulb<E>(W<E>(h.omd), g));
    const float d = (h.flags & FLAG_NESTEROV)
                        ? addb<E>(g, mulb<E>(W<E>(h.momentum), buf))
                        : buf;
    p = __fadd_rn(p, __fmul_rn(-h.lr, d));
    s[0] = buf;
  }
};

template <typename E, bool CENTERED, bool MOMENTUM>
struct RmsPropB {
  static constexpr int NSTATE = 1 + (CENTERED ? 1 : 0) + (MOMENTUM ? 1 : 0);
  static constexpr int AVG = 0;
  static constexpr int MOM = CENTERED ? 1 : 0;
  static constexpr int SQ = NSTATE - 1;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd_b<E>(g, p, h);
    const float sq =
        addb<E>(mulb<E>(W<E>(h.b1), s[SQ]), mulb<E>(mulb<E>(W<E>(h.omb1), g), g));
    float denom;
    if (CENTERED) {
      const float avg =
          addb<E>(mulb<E>(W<E>(h.b1), s[AVG]), mulb<E>(W<E>(h.omb1), g));
      denom = R<E>(sqrtf(addb<E>(R<E>(__fsub_rn(sq, mulb<E>(avg, avg))), W<E>(h.eps))));
      s[AVG] = avg;
    } else {
      denom = addb<E>(R<E>(sqrtf(sq)), W<E>(h.eps));
    }
    s[SQ] = sq;
    if (MOMENTUM) {
      const float buf =
          addb<E>(mulb<E>(W<E>(h.momentum), s[MOM]), R<E>(__fdiv_rn(g, denom)));
      s[MOM] = buf;
      p = __fadd_rn(p, __fmul_rn(-h.lr, buf));
    } else {
      p = __fadd_rn(p, __fdiv_rn(__fmul_rn(-h.lr, g), denom));
    }
  }
};

template <typename E>
struct AdadeltaB {  // states: acc, sq
  static constexpr int NSTATE = 2;
  __device__ static void apply(float g, float& p, float* s, const Hyper& h) {
    g = with_wd_b<E>(g, p, h);
    const float sq =
        addb<E>(mulb<E>(W<E>(h.b1), s[1]), mulb<E>(mulb<E>(W<E>(h.omb1), g), g));
    const float ratio = R<E>(__fdiv_rn(R<E>(sqrtf(addb<E>(s[0], W<E>(h.eps)))),
                                       R<E>(sqrtf(addb<E>(sq, W<E>(h.eps))))));
    const float delta = mulb<E>(ratio, g);
    s[0] = addb<E>(mulb<E>(W<E>(h.b1), s[0]),
                   mulb<E>(mulb<E>(W<E>(h.omb1), delta), delta));
    s[1] = sq;
    p = __fadd_rn(p, __fmul_rn(-h.lr, delta));
  }
};

// first position in ids[0, n) whose id is >= value (n when there is none)
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

// The 16-bit paths of fused_row_update_kernel (E: bfloat16 or float16): the
// same walk, elements widened as they load and rounded as they store (VEC =
// 4: 8-byte accesses).
template <typename E>
struct Elem;
template <>
struct Elem<bf16> {
  using Two = __nv_bfloat162;
  __device__ static float widen(bf16 x) { return __bfloat162float(x); }
  __device__ static float2 widen2(Two x) { return __bfloat1622float2(x); }
  __device__ static bf16 narrow(float x) { return __float2bfloat16_rn(x); }
  __device__ static Two narrow2(float a, float b) { return __floats2bfloat162_rn(a, b); }
};
template <>
struct Elem<__half> {
  using Two = __half2;
  __device__ static float widen(__half x) { return __half2float(x); }
  __device__ static float2 widen2(Two x) { return __half22float2(x); }
  __device__ static __half narrow(float x) { return __float2half_rn(x); }
  __device__ static Two narrow2(float a, float b) { return __floats2half2_rn(a, b); }
};

template <typename E, int VEC>
struct HalfVec;
template <typename E>
struct HalfVec<E, 1> {
  __device__ static void load(const E* p, float* v) { v[0] = Elem<E>::widen(*p); }
  __device__ static void store(E* p, const float* v) { *p = Elem<E>::narrow(v[0]); }
};
template <typename E>
struct HalfVec<E, 4> {
  using Two = typename Elem<E>::Two;
  __device__ static void load(const E* p, float* v) {
    const uint2 raw = *reinterpret_cast<const uint2*>(p);
    const float2 a = Elem<E>::widen2(*reinterpret_cast<const Two*>(&raw.x));
    const float2 b = Elem<E>::widen2(*reinterpret_cast<const Two*>(&raw.y));
    v[0] = a.x, v[1] = a.y, v[2] = b.x, v[3] = b.y;
  }
  __device__ static void store(E* p, const float* v) {
    const Two a = Elem<E>::narrow2(v[0], v[1]);
    const Two b = Elem<E>::narrow2(v[2], v[3]);
    uint2 raw;
    raw.x = *reinterpret_cast<const unsigned*>(&a);
    raw.y = *reinterpret_cast<const unsigned*>(&b);
    *reinterpret_cast<uint2*>(p) = raw;
  }
};

template <typename E>
struct HalfStates {
  E* s[3];
};

template <typename E, typename Rule, int VEC>
__global__ void fused_row_update_half_kernel(
    const int32_t* __restrict__ ids, const int32_t* __restrict__ seg,
    const E* __restrict__ gsum, int n, int Dv, int64_t num_rows,
    E* __restrict__ param, HalfStates<E> states, Hyper h) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t row = (int64_t)blockIdx.x * ROWS_PER_BLOCK + warp;
  if (row >= num_rows) return;
  const int pos = lower_bound(ids, n, row);
  const bool touched = pos < n && ids[pos] == row;
  const E* grow = touched ? gsum + (size_t)seg[pos] * Dv * VEC : nullptr;
  const size_t base = (size_t)row * Dv * VEC;
  for (int col = lane; col < Dv; col += 32) {
    const size_t at = base + (size_t)col * VEC;
    float g[VEC], p[VEC], s[3][VEC];
    HalfVec<E, VEC>::load(param + at, p);
    if (touched) {
      HalfVec<E, VEC>::load(grow + col * VEC, g);
    } else {
#pragma unroll
      for (int e = 0; e < VEC; ++e) g[e] = 0.f;
    }
#pragma unroll
    for (int k = 0; k < Rule::NSTATE; ++k)
      HalfVec<E, VEC>::load(states.s[k] + at, s[k]);
#pragma unroll
    for (int e = 0; e < VEC; ++e) {
      float st[3];
#pragma unroll
      for (int k = 0; k < Rule::NSTATE; ++k) st[k] = s[k][e];
      Rule::apply(g[e], p[e], st, h);
#pragma unroll
      for (int k = 0; k < Rule::NSTATE; ++k) s[k][e] = st[k];
    }
    HalfVec<E, VEC>::store(param + at, p);
#pragma unroll
    for (int k = 0; k < Rule::NSTATE; ++k)
      HalfVec<E, VEC>::store(states.s[k] + at, s[k]);
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

template <typename E, typename Rule>
int launch_half(const int32_t* ids, const int32_t* seg, const void* gsum,
                int n, int D, long long num_rows, void* param, States st,
                int nstate, const Hyper& h, cudaStream_t stream) {
  if (nstate != Rule::NSTATE) return (int)cudaErrorInvalidValue;
  const long long blocks = (num_rows + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
  auto aligned8 = [](const void* q) { return ((uintptr_t)q & 7u) == 0; };
  bool vec = D % 4 == 0 && aligned8(param) && (n == 0 || aligned8(gsum));
  HalfStates<E> states;
  for (int k = 0; k < 3; ++k) {
    states.s[k] = reinterpret_cast<E*>(st.s[k]);
    if (k < Rule::NSTATE) vec = vec && aligned8(st.s[k]);
  }
  const auto* g = reinterpret_cast<const E*>(gsum);
  auto* p = reinterpret_cast<E*>(param);
  if (vec) {
    fused_row_update_half_kernel<E, Rule, 4><<<(unsigned)blocks, THREADS, 0, stream>>>(
        ids, seg, g, n, D / 4, (int64_t)num_rows, p, states, h);
  } else {
    fused_row_update_half_kernel<E, Rule, 1><<<(unsigned)blocks, THREADS, 0, stream>>>(
        ids, seg, g, n, D, (int64_t)num_rows, p, states, h);
  }
  return (int)cudaGetLastError();
}

// The rule's launch on a table of E: float32 with the float32 rules, or a
// 16-bit type with the *B rules.
template <typename E, typename Rule, typename RuleB>
int launch_as(const int32_t* ids, const int32_t* seg, const void* gsum, int n,
              int D, long long num_rows, void* param, States st, int nstate,
              const Hyper& h, cudaStream_t stream) {
  if constexpr (std::is_same<E, float>::value) {
    return launch<Rule>(ids, seg, (const float*)gsum, n, D, num_rows,
                        (float*)param, st, nstate, h, stream);
  } else {
    return launch_half<E, RuleB>(ids, seg, gsum, n, D, num_rows, param, st,
                                 nstate, h, stream);
  }
}

template <typename E>
int dispatch(int rule, const int32_t* ids, const int32_t* seg,
             const void* gsum, int n, int D, long long num_rows, void* param,
             States st, int nstate, const Hyper& h, int flags,
             cudaStream_t s) {
#define KGE_LAUNCH(RULE)                                                  \
  return launch_as<E, RULE, RULE##B<E>>(ids, seg, gsum, n, D, num_rows,   \
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
        return launch_as<E, RmsProp<true, true>, RmsPropB<E, true, true>>(
            ids, seg, gsum, n, D, num_rows, param, st, nstate, h, s);
      }
      if (centered) {
        return launch_as<E, RmsProp<true, false>, RmsPropB<E, true, false>>(
            ids, seg, gsum, n, D, num_rows, param, st, nstate, h, s);
      }
      if (mom) {
        return launch_as<E, RmsProp<false, true>, RmsPropB<E, false, true>>(
            ids, seg, gsum, n, D, num_rows, param, st, nstate, h, s);
      }
      return launch_as<E, RmsProp<false, false>, RmsPropB<E, false, false>>(
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

// The same on a 16-bit table of E: param, the states and gsum are E (the
// pointers are passed as they are), with the *B rules.
template <typename E>
int launch_16(int rule, const int32_t* ids, const int32_t* seg, const void* gsum,
              int n, int D, long long num_rows, void* param, void* s0, void* s1,
              void* s2, int nstate, const float* hyper, int flags, void* stream) {
  if (D <= 0 || num_rows <= 0) return 0;
  States st;
  st.s[0] = (float*)s0, st.s[1] = (float*)s1, st.s[2] = (float*)s2;
  return dispatch<E>(rule, ids, seg, gsum, n, D, num_rows, param, st, nstate,
                     hyper_of(hyper, flags), flags, (cudaStream_t)stream);
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
  return dispatch<float>(rule, ids, seg, gsum, n, D, num_rows, param, st,
                         nstate, hyper_of(hyper, flags), flags,
                         (cudaStream_t)stream);
}

// The same on a bfloat16 table (launch_16).
int fused_row_update_launch_bf16(int rule, const int32_t* ids,
                                 const int32_t* seg, const void* gsum, int n,
                                 int D, long long num_rows, void* param,
                                 void* s0, void* s1, void* s2, int nstate,
                                 const float* hyper, int flags, void* stream) {
  return launch_16<bf16>(rule, ids, seg, gsum, n, D, num_rows, param, s0, s1,
                         s2, nstate, hyper, flags, stream);
}

// The same on a float16 table.
int fused_row_update_launch_f16(int rule, const int32_t* ids,
                                const int32_t* seg, const void* gsum, int n,
                                int D, long long num_rows, void* param,
                                void* s0, void* s1, void* s2, int nstate,
                                const float* hyper, int flags, void* stream) {
  return launch_16<__half>(rule, ids, seg, gsum, n, D, num_rows, param, s0, s1,
                           s2, nstate, hyper, flags, stream);
}

}  // extern "C"
