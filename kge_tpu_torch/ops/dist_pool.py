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

_EPS = 1e-30
_KINDS = {"l1": 0, "cmod": 1}


def pooled_dist_scores_plain(queries: Sequence[torch.Tensor],
                             pool_embs: Sequence[torch.Tensor],
                             sel: torch.Tensor, pool_factor: int,
                             kind: str) -> torch.Tensor:
    """Plain version: gather ``pool[j * pool_factor + sel]``, broadcast
    difference, reduce over d. ``sign(0) = 0`` and ``0 / sqrt(1e-30) = 0``
    come out of autograd's ``abs`` and ``sqrt``."""
    _check(queries, pool_embs, sel, pool_factor, kind)
    K = sel.shape[1]
    rows = (torch.arange(K, device=sel.device)[None, :] * int(pool_factor)
            + sel.long())
    diffs = [q[:, None, :] - p[rows] for q, p in zip(queries, pool_embs)]
    if kind == "l1":
        return -torch.sum(torch.abs(diffs[0]), dim=2)
    return -torch.sum(
        torch.sqrt(diffs[0] * diffs[0] + diffs[1] * diffs[1] + _EPS), dim=2
    )


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
    """``x`` as float32 rows the kernels can stride over: unit stride
    within a row (a column slice of a wider tensor serves as it is)."""
    if x.device != device:
        raise ValueError(f"{name} is on {x.device}, expected {device}")
    if x.dtype != torch.float32:
        raise TypeError(f"{name} must be float32, got {x.dtype}")
    if x.shape[1] > 1 and x.stride(1) != 1:
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
        _KINDS[kind], queries[0].data_ptr(), queries[second].data_ptr(),
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
    out = torch.empty(n, K, dtype=torch.float32, device=device)
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
    return out


def _launch_backward(queries, pools, sel, grad, pool_factor, kind):
    from kge_tpu_torch.ops.kernel_utils import check_launch, load_library, typed

    args, (n, K, F, d), _alive = _common_args(queries, pools, sel, pool_factor, kind)
    device = sel.device
    if grad.dtype != torch.float32 or grad.device != device:
        raise TypeError("the scores' gradient must be float32 on the scores' device")
    parts = len(queries)
    dqs = [torch.empty(n, d, dtype=torch.float32, device=device)
           for _ in range(parts)]
    dpools = [torch.empty(K * F, d, dtype=torch.float32, device=device)
              for _ in range(parts)]
    if K == 0 or d == 0:
        return dqs, dpools
    lib = load_library("dist_pool")
    p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
    launch = typed(lib, "pooled_scores_bwd_launch",
                    [i, p, p, ll, p, p, ll, p, p, i, i, i, i, p, p, p, p, p])
    second = parts - 1
    with torch.cuda.device(device):
        code = launch(*args, grad.data_ptr(), n, K, F, d,
                      dqs[0].data_ptr(), dqs[second].data_ptr(),
                      dpools[0].data_ptr(), dpools[second].data_ptr(),
                      torch.cuda.current_stream(device).cuda_stream)
    check_launch(code, "pooled_scores_bwd")
    pooled_dist_scores.backward_launches += 1
    return dqs, dpools
