"""Pooled distance scores of the translation models (TransE, RotatE with the
L1 norm) as one kernel forward and one backward.

Replaces kge_tpu/ops/dist_pool.py. Distance scorers reduce
``score = -||q - c||`` elementwise over the embedding dimension: there is no
matrix product to lean on, and the plain chain materializes several
``[n, K, d]`` tensors (the gathered candidates, the differences, and their
cotangents). The kernels in ``csrc/dist_pool.cu`` read q, the pool and
``sel`` and write the scores (forward), or ``dq`` and ``dpool`` (backward),
and keep everything of size ``[n, K, d]`` in registers.

Two score kinds, with ``c[i, j] = pool[j * pool_factor + sel[i, j]]`` (the
pool in the sampler's layout: row ``j * pool_factor + f`` holds candidate
``f`` of negative slot ``j``):

- ``l1``:   ``score[i, j] = -sum_d |q[i, d] - c[i, j, d]|``          (TransE)
- ``cmod``: ``score[i, j] = -sum_d sqrt(dre^2 + dim^2 + 1e-30)``     (RotatE)

In bfloat16 (``parallel.compute_dtype: bfloat16``) the inputs and outputs
are bfloat16: each difference, and each of ``cmod``'s squares, sums and
square roots, is rounded to bfloat16 as kge_tpu's kernel rounds it, and the
sum over d is taken in float32 and rounded once (kge_tpu sums in bfloat16
across its d tiles; this is closer to the exact sum). The backward's
factors are rounded likewise and summed in float32, each output rounded
once. The same kernels serve every dtype, with the same tiles, row chunks
and float32 workspace: in bfloat16 they compute the roundings with bfloat16
instructions that round once, which give the float32 operation rounded to
bfloat16, and the square root and the quotient with the card's
approximations, exact once rounded to bfloat16 (``csrc/dist_pool.cu`` says
why; ``bf16_fast_ops_check`` holds them against the IEEE operations on the
card, exhaustively).

In float16 (``parallel.compute_dtype: float16``) the same roundings are
float16's, with one difference: the 1e-30 of ``cmod`` is a weakly typed
constant, which rounds to 0 in float16, so a pair whose squares both
underflow (``|diff|`` below about 2^-12.5 in both parts) has distance 0,
and its factor in the backward is ``g / 0`` times the difference: +-inf, or
NaN where the difference or g is 0, as kge_tpu's ``g rsqrt(0) diff`` is.
The kernels compute float16's roundings with float16 instructions that
round once and keep subnormals, and the square root and the quotient with
the card's approximations made exact: the square root against the square
of the float16 midpoint beside it, the quotient refined once by its exact
residual (``csrc/dist_pool.cu`` says why each is float16's IEEE result;
``f16_fast_ops_check`` holds them against the IEEE operations on the card,
exhaustively), so every element, and every output, has the bits of IEEE
operations rounded one at a time.

``pooled_dist_scores`` is differentiable in the queries and the pool
(``torch.autograd.Function``; the backward is a kernel too). Beside it
stands ``pooled_dist_scores_plain``, the same function in plain PyTorch
differentiated by autograd: the path for tensors on the CPU, and the
kernels' oracle on the card. A CUDA tensor goes to the kernels or the
wrapper raises. ``pooled_dist_scores.launches`` counts forward launches,
``pooled_dist_scores.backward_launches`` backward ones.
"""

from __future__ import annotations

import ctypes
from typing import Sequence

import torch

from kge_tpu_torch.utils.dtypes import strong32, weak

_EPS = 1e-30
_KINDS = {"l1": 0, "cmod": 1}
#: added to the kind code for bfloat16 and for float16 tensors
#: (csrc/dist_pool.cu)
_KIND_OFFSET = {torch.float32: 0, torch.bfloat16: 2, torch.float16: 4}

# dpool's work units, as csrc/dist_pool.cu has them: a block of DPOOL_UNITS
# warps, each the owner of DPOOL_UNIT_ROWS pool rows of one slot; the rows i
# staged DPOOL_STAGE_ROWS at a time
DPOOL_UNITS, DPOOL_UNIT_ROWS, DPOOL_STAGE_ROWS = 16, 4, 64
#: blocks the row chunking aims at (a few per SM of an H100), and the most
#: bytes the chunks' partial sums may take
DPOOL_BLOCKS = 256
DPOOL_WORKSPACE_BYTES = 64 << 20


def pooled_dist_scores_plain(queries: Sequence[torch.Tensor],
                             pool_embs: Sequence[torch.Tensor],
                             sel: torch.Tensor, pool_factor: int,
                             kind: str) -> torch.Tensor:
    """Plain version: gather ``pool[j * pool_factor + sel]``, broadcast
    difference, reduce over d. ``sign(0) = 0`` and ``0 / sqrt(1e-30) = 0``
    come out of autograd's ``abs`` and ``sqrt``. In bfloat16 and float16
    the gather and the subtraction run in float32, each difference is
    rounded to the dtype, and the sum over d is float32 rounded once; so
    autograd's backward sums ``dq`` and ``dpool`` in float32 too. In
    float16 the 1e-30 is 0, and a zero distance's ``sqrt`` backward is
    ``g / 0``."""
    _check(queries, pool_embs, sel, pool_factor, kind)
    K = sel.shape[1]
    dtype = queries[0].dtype
    rows = (torch.arange(K, device=sel.device)[None, :] * int(pool_factor)
            + sel.long())
    diffs = [(strong32(q)[:, None, :] - strong32(p)[rows]).to(dtype)
             for q, p in zip(queries, pool_embs)]
    if kind == "l1":
        dist = torch.abs(diffs[0])
    else:
        dist = torch.sqrt(diffs[0] * diffs[0] + diffs[1] * diffs[1]
                          + weak(_EPS, diffs[0]))
    return (-torch.sum(strong32(dist), dim=2)).to(dtype)


def dpool_plan(n: int, K: int, F: int, d: int, parts: int):
    """How the dpool launch splits the rows i: ``chunks`` chunks of
    ``rows_per_chunk`` rows (whole stages), ascending, covering ``[0, n)``.

    The launch has ``unit_blocks`` x ``tiles`` blocks a chunk: unit ``u`` of
    ``unit_blocks * DPOOL_UNITS`` owns slot ``j = u // f_blocks`` (if ``j <
    K``) and its pool rows ``j * F + (u % f_blocks) * DPOOL_UNIT_ROWS + k``
    below ``(j + 1) * F``, for every column tile of ``tile_cols`` columns
    (narrower on the scalar path, which only adds blocks). Chunks are there
    to fill the card where the units alone give few blocks; with more than
    one, the partial sums take ``workspace_floats`` floats (chunks x parts x
    K F x d, at most ``DPOOL_WORKSPACE_BYTES``) and ``counters`` zeroed
    ints, one per (unit block, tile of 32 columns or more)."""
    if min(n, K, F, d) < 0 or F < 1 or parts not in (1, 2):
        raise ValueError("dpool_plan takes non-negative sizes, F >= 1 and 1 or 2 parts")
    f_blocks = -(-F // DPOOL_UNIT_ROWS)
    unit_blocks = -(-K * f_blocks // DPOOL_UNITS)
    tile_cols = 128
    tiles = -(-d // tile_cols)
    stages = -(-n // DPOOL_STAGE_ROWS)
    partial_bytes = 4 * parts * K * F * d
    chunks = max(1, min(stages, -(-DPOOL_BLOCKS // max(1, unit_blocks * tiles)),
                        DPOOL_WORKSPACE_BYTES // max(1, partial_bytes)))
    rows_per_chunk = max(1, -(-stages // chunks)) * DPOOL_STAGE_ROWS
    chunks = max(1, -(-n // rows_per_chunk))
    several = chunks > 1
    return {
        "f_blocks": f_blocks, "unit_blocks": unit_blocks, "tile_cols": tile_cols,
        "tiles": tiles, "rows_per_chunk": rows_per_chunk, "chunks": chunks,
        "workspace_floats": chunks * parts * K * F * d if several else 0,
        "counters": unit_blocks * -(-d // 32) if several else 0,
    }


def dpool_scratch(plan, device):
    """The partial sums' workspace of ``plan`` (float32, whatever the
    dtype of the tensors: the chunks' sums stay float32 until the last
    block rounds them) and its zeroed counters."""
    return (torch.empty(plan["workspace_floats"], dtype=torch.float32, device=device),
            torch.zeros(plan["counters"], dtype=torch.int32, device=device))


#: what ``bf16_fast_ops_check`` counts, in the order of the kernel's counts
BF16_CHECK_COUNTS = (
    "sub_differ", "add_differ", "mul_differ", "sqrt_differ", "sqrt_inputs",
    "sqrt_differ_outside", "quotient_differ", "quotient_pairs",
)
#: what ``f16_fast_ops_check`` counts, in the order of the kernel's counts
F16_CHECK_COUNTS = (
    "sub_differ", "add_differ", "mul_differ", "sqrt_differ", "sqrt_inputs",
    "quotient_differ", "quotient_pairs",
)


def _fast_ops_check(entry: str, names, device) -> dict:
    """Launch the exhaustive check ``entry`` of csrc/dist_pool.cu on
    ``device`` (a CUDA card) and return its counts by ``names``."""
    from kge_tpu_torch.ops.kernel_utils import check_launch, load_library, typed

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"{entry} runs on a CUDA card, not {device}")
    counts = torch.zeros(len(names), dtype=torch.int64, device=device)
    lib = load_library("dist_pool")
    launch = typed(lib, entry, [ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(device):
        code = launch(counts.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    check_launch(code, entry)
    return dict(zip(names, counts.tolist()))


def bf16_fast_ops_check(device) -> dict:
    """The bfloat16 path's fast operations against the IEEE ones, on the
    card, exhaustively (``csrc/dist_pool.cu`` ``bf16_ops_check_kernel``):
    for all 2^32 pairs of bfloat16 values, the pairs whose one-rounding
    difference, sum and product differ from the float32 operation's rounded
    to bfloat16; for every non-negative bfloat16 t, the fast square roots
    that differ from ``R(sqrt(t))`` where the kernels take them (t in
    [R(1e-30), +inf]: ``sqrt_inputs`` of them) and elsewhere; for every g of
    the fast quotient's range and every distance in [2^-50, 2^64] or +inf
    (``quotient_pairs``), the quotients that differ from ``R(g / R(2
    dist))``."""
    return _fast_ops_check("bf16_fast_ops_check", BF16_CHECK_COUNTS, device)


def f16_fast_ops_check(device) -> dict:
    """The float16 path's fast operations against the IEEE ones, on the
    card, exhaustively (``csrc/dist_pool.cu`` ``f16_ops_check_kernel``):
    for all 2^32 pairs of float16 values, the pairs whose one-rounding
    difference, sum and product differ from the float32 operation's rounded
    to float16; for every non-negative float16 t (``sqrt_inputs``: +inf and
    NaN too), the square roots that differ from ``R(sqrt(t))``; for every
    float16 g and every D with its sign bit clear (``quotient_pairs``:
    2^31, which hold every ``D = R(2 dist)`` of the kernels), the quotients
    that differ from ``R(g / D)``. Equal is the same bits, or NaN on both
    sides."""
    return _fast_ops_check("f16_fast_ops_check", F16_CHECK_COUNTS, device)


def _check(queries, pool_embs, sel, pool_factor, kind):
    if kind not in _KINDS:
        raise ValueError(f"unknown pooled distance kind: {kind}")
    if len(queries) != (1 if kind == "l1" else 2):
        raise ValueError("queries arity does not match kind")
    if len(pool_embs) != len(queries):
        raise ValueError("pool_embs arity does not match queries")
    if sel.dim() != 2 or int(pool_factor) < 1:
        raise ValueError("sel must be [n, K] and pool_factor >= 1")
    n, K = sel.shape
    d = queries[0].shape[-1]
    dtype = queries[0].dtype
    if any(x.dtype != dtype for x in (*queries, *pool_embs)):
        raise TypeError(
            "pooled scores take queries and pools of one dtype, got "
            f"{[x.dtype for x in (*queries, *pool_embs)]}")
    for q, p in zip(queries, pool_embs):
        if tuple(q.shape) != (n, d) or tuple(p.shape) != (K * int(pool_factor), d):
            raise ValueError(
                f"pooled scores take queries [n, d] and pools [K * "
                f"pool_factor, d] for sel [n, K]; got {tuple(q.shape)}, "
                f"{tuple(p.shape)} and {tuple(sel.shape)} at pool_factor "
                f"{pool_factor}"
            )


def pooled_dist_scores(queries: Sequence[torch.Tensor],
                       pool_embs: Sequence[torch.Tensor], sel: torch.Tensor,
                       pool_factor: int, kind: str) -> torch.Tensor:
    """Pooled distance scores [n, K].

    ``queries``: one [n, d] tensor (kind "l1") or the (re, im) pair (kind
    "cmod"). ``pool_embs``: matching pool mini-table(s) [K * pool_factor, d]
    in the sampler's layout. ``sel`` [n, K] picks each row's candidate
    within its group. Differentiable in queries and pool_embs; ``sel`` gets
    no gradient.
    """
    _check(queries, pool_embs, sel, pool_factor, kind)
    device = queries[0].device
    if device.type == "cpu":
        return pooled_dist_scores_plain(queries, pool_embs, sel, pool_factor, kind)
    if device.type != "cuda":
        raise ValueError(f"pooled_dist_scores: unsupported device {device}")
    return _PooledScores.apply(
        sel.to(torch.int32).contiguous(), int(pool_factor), kind,
        *queries, *pool_embs,
    )


#: launches of the forward kernel (K5a) and of the backward kernels (K5b:
#: one count per backward, which launches dq and dpool)
pooled_dist_scores.launches = 0
pooled_dist_scores.backward_launches = 0
#: of those, the launches on bfloat16 and on float16 tensors
pooled_dist_scores.bf16_launches = 0
pooled_dist_scores.bf16_backward_launches = 0
pooled_dist_scores.f16_launches = 0
pooled_dist_scores.f16_backward_launches = 0


class _PooledScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, sel, pool_factor, kind, *tensors):
        parts = len(tensors) // 2
        queries, pools = tensors[:parts], tensors[parts:]
        ctx.save_for_backward(sel, *tensors)
        ctx.pool_factor, ctx.kind = pool_factor, kind
        return _launch_forward(queries, pools, sel, pool_factor, kind)

    @staticmethod
    def backward(ctx, grad):
        sel, *tensors = ctx.saved_tensors
        parts = len(tensors) // 2
        dqs, dpools = _launch_backward(
            tensors[:parts], tensors[parts:], sel, grad.contiguous(),
            ctx.pool_factor, ctx.kind,
        )
        return (None, None, None, *dqs, *dpools)


def _rows(name, x, device):
    """``x`` as float32, bfloat16 or float16 rows the kernels can stride
    over: unit stride within a row (a column slice of a wider tensor serves
    as it is)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype not in _KIND_OFFSET:
        raise TypeError(
            f"{name} must be float32, bfloat16 or float16, got {x.dtype}")
    if x.shape[0] > 0 and x.shape[1] > 1 and x.stride(1) != 1:
        raise ValueError(f"{name} must have unit stride within a row")
    return x


def _common_args(queries, pools, sel, pool_factor, kind):
    device = sel.device
    queries = [_rows("queries", q.detach(), device) for q in queries]
    pools = [_rows("pool_embs", p.detach(), device) for p in pools]
    if len({q.stride(0) for q in queries}) != 1 or len(
        {p.stride(0) for p in pools}
    ) != 1:
        queries = [q.contiguous() for q in queries]
        pools = [p.contiguous() for p in pools]
    if sel.dtype != torch.int32 or not sel.is_contiguous():
        raise TypeError("sel must be contiguous int32")
    n, K = sel.shape
    d = queries[0].shape[1]
    second = 1 if kind == "cmod" else 0
    args = [
        _KINDS[kind] + _KIND_OFFSET[queries[0].dtype],
        queries[0].data_ptr(), queries[second].data_ptr(),
        queries[0].stride(0), pools[0].data_ptr(), pools[second].data_ptr(),
        pools[0].stride(0), sel.data_ptr(),
    ]
    # the tensors are returned too: a contiguous copy made here must live
    # until the launch is enqueued
    return args, (n, K, int(pool_factor), d), (queries, pools)


def _launch_forward(queries, pools, sel, pool_factor, kind):
    from kge_tpu_torch.ops.kernel_utils import check_launch, load_library, typed

    args, (n, K, F, d), _alive = _common_args(queries, pools, sel, pool_factor, kind)
    device = sel.device
    out = torch.empty(n, K, dtype=queries[0].dtype, device=device)
    if n == 0 or K == 0:
        return out
    lib = load_library("dist_pool")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = typed(lib, "pooled_scores_launch",
                    [i, p, p, ll, p, p, ll, p, i, i, i, i, p, p])
    with torch.cuda.device(device):
        code = launch(*args, n, K, F, d, out.data_ptr(),
                      torch.cuda.current_stream(device).cuda_stream)
    check_launch(code, "pooled_scores")
    pooled_dist_scores.launches += 1
    pooled_dist_scores.bf16_launches += out.dtype == torch.bfloat16
    pooled_dist_scores.f16_launches += out.dtype == torch.float16
    return out


def _launch_backward(queries, pools, sel, grad, pool_factor, kind):
    from kge_tpu_torch.ops.kernel_utils import check_launch, load_library, typed

    args, (n, K, F, d), _alive = _common_args(queries, pools, sel, pool_factor, kind)
    device = sel.device
    dtype = queries[0].dtype
    if grad.dtype != dtype or grad.device != device:
        raise TypeError(
            f"the scores' gradient must be {dtype} on the scores' device")
    parts = len(queries)
    dqs = [torch.empty(n, d, dtype=dtype, device=device) for _ in range(parts)]
    dpools = [torch.empty(K * F, d, dtype=dtype, device=device)
              for _ in range(parts)]
    if K == 0 or d == 0:
        return dqs, dpools
    plan = dpool_plan(n, K, F, d, parts)
    ws, counters = dpool_scratch(plan, device)
    lib = load_library("dist_pool")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = typed(lib, "pooled_scores_bwd_launch",
                    [i, p, p, ll, p, p, ll, p, p, i, i, i, i, p, p, p, p, i, i, p, p,
                     p])
    second = parts - 1
    with torch.cuda.device(device):
        code = launch(*args, grad.data_ptr(), n, K, F, d,
                      dqs[0].data_ptr(), dqs[second].data_ptr(),
                      dpools[0].data_ptr(), dpools[second].data_ptr(),
                      plan["rows_per_chunk"], plan["chunks"],
                      ws.data_ptr() if ws.numel() else None,
                      counters.data_ptr() if counters.numel() else None,
                      torch.cuda.current_stream(device).cuda_stream)
    check_launch(code, "pooled_scores_bwd")
    pooled_dist_scores.backward_launches += 1
    pooled_dist_scores.bf16_backward_launches += dtype == torch.bfloat16
    pooled_dist_scores.f16_backward_launches += dtype == torch.float16
    return dqs, dpools
