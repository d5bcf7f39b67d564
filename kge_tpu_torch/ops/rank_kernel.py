"""Fused filtered-rank counts: score block, tie counts and label values
without holding the batch x |E| score matrix.

Replaces the TPU kernel ``kge_tpu/ops/rank_kernel.py`` ``fused_rank_counts``
(Pallas body ``_kernel``, tie rule ``_close_greater``) with the CUDA C++
kernels of ``csrc/rank_counts.cu``: a register-blocked float32 product on
the CUDA cores (a block owns 64 query rows and a range of 128-column tiles,
a thread 8 x 8 accumulators; slices of both operands stream through a
three-stage ``cp.async`` ring in shared memory) with the counts as its
epilogue, after a small launch that computes the pivots. At evaluation
shapes the fp32 CUDA-core rate bounds it (about 60 flops per byte of
input); the bfloat16 and float16 paths' tiles run on the tensor cores
(below). The
grid is (row tiles) x (column ranges): ``rank_plan`` cuts the candidate
columns into ranges of whole tiles (one tile each: many short
blocks balance the SMs best), and the blocks of
a row tile add their int32 counts with ``atomicAdd``, exact in any order, so
the outputs are bit-equal across launches and across plans. Measured by
``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 (700 W) at n = 256,
|E| = 14,541, D = 512: about 0.135 ms a call, against a bound of 0.057 ms
and 0.28 ms for ``torch.matmul`` and the compares (PERF.md has the table).

Beside the kernel stand its plain PyTorch version (``fused_rank_counts_plain``,
the path for tensors on the CPU and the kernel's oracle on the card) and
launch counters (``fused_rank_counts.launches``, and of those the launches
with a score epilogue, ``fused_rank_counts.epilogue_launches``, and those of
the bfloat16 and the float16 paths, ``fused_rank_counts.bf16_launches`` and
``fused_rank_counts.f16_launches``). A CUDA
tensor goes to the kernel or the wrapper raises; no path falls back to the
plain version.

Differences from the TPU kernel's interface, all for the card:

- Labels come per row in CSR form (``row_ptr [n+1]``, ``cols`` ascending and
  unique within each row) and ``vals`` is aligned with ``cols``; some
  FB15k-237 queries have thousands of answers, which a padded [n, kmax]
  block would multiply by n.
- ``pivot_cols`` asks for the pivot to be the row's own score at that
  column, computed with the same float32 FMA chain as the tile, so the true
  entity ties with itself exactly. The pivot used is returned. An explicit
  ``pivot``, as the TPU kernel takes it, serves the candidates of a
  row-sharded table (the model axis of parallel/mesh.py): ``rank_pivots``
  computes the pivot by the prologue's chain on the rank that holds the
  true column, the ranks sum it, and each ranks its own columns against it
  (``fused_rank_counts.sharded_launches``). The counts, pivots and label
  values summed over the shards are the unsharded launch's in every bit.

- ``score_map``, the TPU kernel's score epilogue, is a Python callable
  there. A callable cannot cross into CUDA, so here it must be a named
  epilogue (``ScoreEpilogue``) whose integer code the kernel takes:
  ``NEG_SQRT_L2`` (code 1), ``-sqrt(max(-dot, 0) + 1e-30)``, the epilogue of
  the L2 distance scorers' augmented factorization
  (models/translation.py ``_l2_factorization``). The kernel applies it to
  the pivot, to every tile score before the compares and so to every label
  value; the plain version calls it on the product. Any other callable
  raises.

Precision is float32 for float32 inputs (the TPU kernel rounds its inputs
to bf16): every score is one FMA chain over the embedding dimension in
ascending order, whatever the plan, and the epilogue's float operations
round one by one (the sqrt correctly rounded, as ``torch.sqrt``'s on the
card), so the true entity ties with itself exactly under the epilogue too.
The float32 path leaves the tensor cores out for that reason.

bfloat16 inputs (``parallel.compute_dtype: bfloat16``) take the kernel's
bfloat16 path. Its outputs are defined by the same float32 chain over the
bfloat16 values (each product is exact in float32, so the chain is a sum of
exact products in ascending order), each score rounded once to bfloat16,
and the epilogue and the tie test computed in bfloat16 with a rounding
after every operation, as kge_tpu's evaluation ranks its bfloat16 score
matrix (kge_tpu/job/eval_entity_ranking.py ``_close_greater``). ``vals``
and the pivot are bfloat16 then. The plain version sums the same products
in the same order (``chain_scores``), so its counts equal the kernel's.
The kernel multiplies the tiles on the tensor cores (``mma.sync`` on raw
bfloat16 slices, float32 accumulators), whose sums are not the chain's
bits, and keeps the chain's decisions by a certificate: each tensor-core
sum lies within ``certificate_bound`` of its chain (a multiple of
``||q_i|| ||t_j||``), and the category of an entry (below, close, greater)
is a non-decreasing function of the chain's value. So where both ends of
that interval fall in one category, the entry is counted from the tensor
cores' sum; every other entry, and every label column, is recomputed by the
chain (``certified_categories`` is the rule in PyTorch). The number of
entries the certificate left undecided is
``fused_rank_counts.last_recounted`` (a device tensor, read by the checks
only).

float16 inputs (``parallel.compute_dtype: float16``) take the kernel's
float16 path, defined as the bfloat16 path is with float16 in its place (a
product of two float16 values is exact in float32 as well): the float32
chain, each score rounded once to float16, the epilogue and the tie test in
float16 after every operation, ``vals`` and the pivot in float16. float16's
range ends at 65,504: a larger score becomes an infinity, which the tie
rule treats as kge_tpu's does, and the L2 epilogue's 1e-30 rounds to 0, so
a product at or above 0 scores -0.0. The kernel runs the bfloat16 path's
tensor-core tiles, certificate and recount over float16 (``chain_scores``
is its plain version's product). The certificate carries over: the
category stays non-decreasing in the chain's value (overflow to +-inf
included), and the tensor cores read float16 subnormals exactly
(``f16_subnormal_check``: all 2^32 pairs of float16 values, one product an
accumulator, equal the exact products on the H100), so a row with
subnormal values keeps a finite norm bound (csrc/rank_counts.cu, "float16
path", has the proof). ``fused_rank_counts.last_recounted`` covers both
16-bit paths.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

from kge_tpu_torch.ops.kernel_utils import ENTRY_SUFFIX as _SUFFIX
from kge_tpu_torch.utils.dtypes import weak

_KERNEL = "rank_counts"
#: candidate columns per tile of the kernel (BN of csrc/rank_counts.cu)
TILE_COLS = 128
#: query rows per block of the kernel (BM of csrc/rank_counts.cu)
TILE_ROWS = 64
#: entries of the 16-bit paths' recount worklist: the undecided entries
#: of a block that finds it full are recounted by the block itself
RECOUNT_CAPACITY = 1 << 20
#: the dtypes whose scores are rounded chains (``chain_scores``)
_CHAINED = (torch.bfloat16, torch.float16)


class ScoreEpilogue:
    """A named score epilogue: ``code`` is what the CUDA kernel takes, and a
    call applies the same map to a tensor of scores in PyTorch."""

    def __init__(self, name: str, code: int, fn):
        self.name, self.code, self._fn = name, code, fn

    def __call__(self, scores: torch.Tensor) -> torch.Tensor:
        return self._fn(scores)

    def __repr__(self):
        return f"ScoreEpilogue({self.name!r}, {self.code})"


#: -||q - c||_2 from the augmented product -||q - c||^2, clamped at 0
#: against cancellation (kge_tpu/models/translation.py ``_l2_factorization``)
NEG_SQRT_L2 = ScoreEpilogue(
    "neg_sqrt_l2", 1,
    lambda dot: -torch.sqrt(torch.clamp(-dot, min=0.0) + weak(1e-30, dot)),
)


def rank_plan(n: int, num_valid: int, *,
              num_ranges: Optional[int] = None) -> Dict[str, int]:
    """The kernel's grid for ``n`` query rows and ``num_valid`` candidate
    columns: ``row_tiles`` x ``num_ranges`` blocks, where range ``r`` covers
    the tiles ``[r * tiles_per_range, min((r + 1) * tiles_per_range,
    num_tiles))`` of ``TILE_COLS`` columns. The ranges partition
    ``[0, num_valid)`` in whole tiles and none is empty. By default a range
    is one tile (more only where the grid's second dimension, 65,535 blocks,
    asks for it): many short blocks let the card's block scheduler even out
    its SMs, which measured faster than one wave of long ones and the same
    as two to eight tiles a block on 200,000 columns. ``num_ranges`` asks
    for a number of ranges instead (rounded to whole tiles)."""
    if n < 0 or num_valid < 0:
        raise ValueError("rank_plan takes non-negative sizes")
    row_tiles = -(-n // TILE_ROWS)
    num_tiles = -(-num_valid // TILE_COLS)
    if num_ranges is None:
        tiles_per_range = 1
    else:
        num_ranges = max(1, min(num_ranges, num_tiles))
        tiles_per_range = max(1, -(-num_tiles // num_ranges))
    # the grid's second dimension holds 65,535 blocks
    tiles_per_range = max(tiles_per_range, -(-num_tiles // 65535))
    return {
        "tile_rows": TILE_ROWS, "tile_cols": TILE_COLS, "row_tiles": row_tiles,
        "num_tiles": num_tiles, "tiles_per_range": tiles_per_range,
        "num_ranges": -(-num_tiles // tiles_per_range),
    }


def plan_ranges(plan: Dict[str, int], num_valid: int):
    """The column ranges ``[(start, stop), ...]`` of a plan."""
    width = plan["tiles_per_range"] * plan["tile_cols"]
    return [(r * width, min((r + 1) * width, num_valid))
            for r in range(plan["num_ranges"])]


def close_greater(scores: torch.Tensor, true: torch.Tensor, atol: float,
                  rtol: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Tie (isclose) and strictly-greater masks with kge_tpu's NaN/-inf
    conventions: NaN reads as -inf, two -inf are close, and a close score is
    never greater. ``true`` broadcasts against ``scores``."""
    neg_inf = torch.tensor(float("-inf"), dtype=scores.dtype,
                           device=scores.device)
    scores = torch.where(torch.isnan(scores), neg_inf, scores)
    true = torch.where(torch.isnan(true), neg_inf, true)
    finite = torch.isfinite(scores) | torch.isfinite(true)
    is_close = (scores - true).abs() <= (
        weak(atol, true) + weak(rtol, true) * true.abs())
    both_neg_inf = torch.isneginf(scores) & torch.isneginf(true)
    is_close = both_neg_inf | (is_close & finite)
    is_greater = (scores > true) & ~is_close
    return is_close, is_greater


def csr_row_ids(row_ptr: torch.Tensor) -> torch.Tensor:
    """Row index of every CSR entry."""
    n = row_ptr.numel() - 1
    counts = (row_ptr[1:] - row_ptr[:-1]).long()
    return torch.repeat_interleave(
        torch.arange(n, device=row_ptr.device), counts
    )


def csr_row_sums(row_ptr: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Per-row count of the true entries of ``mask`` (one entry per CSR
    column), by prefix sums: integer and deterministic on any device."""
    csum = torch.zeros(mask.numel() + 1, dtype=torch.int64, device=mask.device)
    torch.cumsum(mask.to(torch.int64), 0, out=csum[1:])
    ptr = row_ptr.long()
    return (csum[ptr[1:]] - csum[ptr[:-1]]).to(torch.int32)


def chain_sums(q: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """The float32 chains of ``q @ targets.T`` for bfloat16 or float16
    operands: one sum per score over k ascending from 0 (a product of two
    bfloat16 or two float16 values is exact in float32, so an FMA and a
    multiply-then-add agree)."""
    qf, tf = q.float(), targets.float()
    acc = torch.zeros(q.shape[0], targets.shape[0], dtype=torch.float32,
                      device=q.device)
    for k in range(q.shape[1]):
        acc.addcmul_(qf[:, k, None], tf[None, :, k])
    return acc


def chain_scores(q: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
    """``q @ targets.T`` for bfloat16 or float16 operands as the kernel
    computes it: ``chain_sums`` rounded once to q's dtype."""
    return chain_sums(q, targets).to(q.dtype)


# -- the certificate of the 16-bit paths (csrc/rank_counts.cu, header) -------
#
# The kernel computes these with directed roundings (__fmul_ru, __fmaf_ru,
# __fsub_rd, __fadd_ru); the functions below give the same float32 results
# from exact float64 intermediates.


def certificate_gamma(D: int) -> float:
    """gamma_D: the tensor cores' sum lies within gamma_D S of the chain,
    S = sum_k |q_k t_k|; D16 2^-21 with D16 the depth rounded up to 16 (the
    derivation is in csrc/rank_counts.cu)."""
    return 16 * -(-D // 16) * 2.0 ** -21


def certificate_eta(D: int) -> float:
    """eta_D, the absolute term for values flushed below 2^-126."""
    return 16 * -(-D // 16) * 2.0 ** -124


def chain_error_factor(D: int) -> float:
    """The chain's own part of gamma_D: (D - 1) u / (1 - (D - 1) u), u =
    2^-24, the bound of recursive summation of D exact products."""
    m = (max(D, 1) - 1) * 2.0 ** -24
    return m / (1.0 - m)


def _two_sum(a: torch.Tensor, b: torch.Tensor):
    """s + err == a + b exactly, s = fl(a + b) in float64 (Knuth)."""
    s = a + b
    bp = s - a
    return s, (a - (s - bp)) + (b - bp)


def _round_f32(hi: torch.Tensor, lo: torch.Tensor, up: bool) -> torch.Tensor:
    """The float32 rounding of hi + lo (float64, |lo| at most half an ulp
    of hi) upward or downward."""
    r = hi.float()
    r64 = r.double()
    if up:
        bump = (r64 < hi) | ((r64 == hi) & (lo > 0))
    else:
        bump = (r64 > hi) | ((r64 == hi) & (lo < 0))
    toward = torch.full_like(r, float("inf") if up else float("-inf"))
    return torch.where(bump, torch.nextafter(r, toward), r)


def certificate_bound(norm_q: torch.Tensor, norm_t: torch.Tensor,
                      D: int) -> torch.Tensor:
    """E [n, m] as the kernel's epilogue computes it from the norm bounds
    (float32 [n] and [m]): RU(gamma_D RU(N_i M_j) + eta_D), +inf where
    RU(N_i M_j) exceeds 2^126 or is no number."""
    prod = norm_q.double()[:, None] * norm_t.double()[None, :]  # exact
    nm = _round_f32(prod, torch.zeros_like(prod), up=True)
    scaled = nm.double() * certificate_gamma(D)  # exact: few bits each
    eta = torch.full_like(scaled, certificate_eta(D))
    e = _round_f32(*_two_sum(scaled, eta), up=True)
    return torch.where(nm <= 2.0 ** 126, e, torch.full_like(e, float("inf")))


def certified_categories(x: torch.Tensor, bound: torch.Tensor,
                         pivot: torch.Tensor, atol: float, rtol: float,
                         score_map=None) -> torch.Tensor:
    """The certificate's rule, as the kernel's epilogue applies it: for
    float32 sums ``x`` [n, m] that lie within ``bound`` of their chains, the
    chain's category of each entry (int8: 0 below the pivot, 1 close, 2
    greater, under ``close_greater`` against ``pivot`` [n], bfloat16 or
    float16, after the rounding to the pivot's dtype and ``score_map``), or
    -1 where the rule cannot settle it: lo = RD(x - bound) and hi = RU(x +
    bound) fall in different categories, either is not finite, or the row's
    pivot or tolerance is not finite. Not on any main path: the tests and
    chip_smoke.py check the kernel's decisions with it."""
    if pivot.dtype not in _CHAINED:
        raise TypeError(f"certified_categories: the pivot must be bfloat16 or "
                        f"float16, got {pivot.dtype}")
    x64, b64 = x.double(), bound.double()
    lo = _round_f32(*_two_sum(x64, -b64), up=False)
    hi = _round_f32(*_two_sum(x64, b64), up=True)
    p = torch.where(torch.isnan(pivot), torch.full_like(pivot, float("-inf")), pivot)
    tol = weak(atol, p) + weak(rtol, p) * p.abs()
    ok_row = (torch.isfinite(p) & torch.isfinite(tol))[:, None]

    def category(v):
        s = v.to(p.dtype)
        if score_map is not None:
            s = score_map(s)
        close, greater = close_greater(s, p[:, None], atol, rtol)
        return close.to(torch.int8) + 2 * greater.to(torch.int8)

    a, b = category(lo), category(hi)
    decided = ok_row & torch.isfinite(lo) & torch.isfinite(hi) & (a == b)
    return torch.where(decided, a, torch.full_like(a, -1))


def fused_rank_counts_plain(q, targets, pivot, row_ptr, cols, num_valid: int,
                            atol: float, rtol: float, score_map=None,
                            pivot_cols=None):
    """The plain PyTorch version: materializes the [n, num_valid] scores
    (bfloat16 and float16 ones by ``chain_scores``)."""
    if q.dtype in _CHAINED:
        scores = chain_scores(q, targets[:num_valid])
    else:
        scores = q @ targets[:num_valid].T
    if score_map is not None:
        scores = score_map(scores)
    if pivot_cols is not None:
        pivot = scores.gather(1, pivot_cols.long()[:, None])[:, 0]
    close, greater = close_greater(scores, pivot[:, None], atol, rtol)
    g = greater.sum(dim=1, dtype=torch.int32)
    c = close.sum(dim=1, dtype=torch.int32)
    rows = csr_row_ids(row_ptr)
    in_range = cols < num_valid
    picked = scores[rows, cols.long().clamp(0, max(num_valid - 1, 0))] \
        if num_valid > 0 else torch.zeros_like(cols, dtype=q.dtype)
    vals = torch.where(in_range, picked, torch.zeros_like(picked))
    return g, c, vals, pivot


def rank_pivots_plain(q, targets, pivot_cols, col_lo: int, score_map=None):
    """The plain version of ``rank_pivots``: the scores of
    ``fused_rank_counts_plain`` at the columns held, -0.0 elsewhere."""
    local = pivot_cols.long() - col_lo
    held = (local >= 0) & (local < targets.shape[0])
    if q.dtype in _CHAINED:
        scores = chain_scores(q, targets)
    else:
        scores = q @ targets.T
    if score_map is not None:
        scores = score_map(scores)
    if targets.shape[0] == 0:
        return torch.full((q.shape[0],), -0.0, dtype=q.dtype, device=q.device)
    picked = scores.gather(1, torch.where(held, local, 0)[:, None])[:, 0]
    return torch.where(held, picked, torch.full_like(picked, -0.0))


def rank_pivots(q: torch.Tensor, targets: torch.Tensor,
                pivot_cols: torch.Tensor, col_lo: int, score_map=None):
    """The pivots of the rows of ``q`` [n, D] whose true column
    ``pivot_cols[i]`` (an id of the whole table) lies among the rows
    ``[col_lo, col_lo + len(targets))`` that ``targets`` holds: the chain
    score of ``fused_rank_counts`` at that column, after ``score_map``; -0.0
    for the other rows, so that the sum over the shards of a table is the
    pivot in every bit. On the card the prologue's pivot launch alone of
    csrc/rank_counts.cu (``rank_pivots.launches``); on the CPU the plain
    version."""
    if score_map is not None and not isinstance(score_map, ScoreEpilogue):
        raise NotImplementedError(
            f"rank_pivots: score_map {score_map!r} is not a named epilogue")
    n, D = q.shape
    if targets.dim() != 2 or targets.shape[1] != D or targets.dtype != q.dtype:
        raise ValueError(f"targets {tuple(targets.shape)} {targets.dtype} do "
                         f"not match q {tuple(q.shape)} {q.dtype}")
    if pivot_cols.shape != (n,):
        raise ValueError(f"pivot_cols must have shape ({n},)")
    if q.device.type == "cpu":
        return rank_pivots_plain(q, targets, pivot_cols, col_lo, score_map)
    if q.device.type != "cuda":
        raise ValueError(f"rank_pivots: unsupported device {q.device}")
    from kge_tpu_torch.ops.kernel_utils import check_launch, require

    dtype = q.dtype
    if dtype not in _SUFFIX:
        raise TypeError(
            f"rank_pivots takes float32, bfloat16 or float16, got {dtype}")
    require("q", q, q.device, dtype)
    require("targets", targets, q.device, dtype)
    require("pivot_cols", pivot_cols, q.device, torch.int32)
    out = torch.empty(n, dtype=dtype, device=q.device)
    if n == 0:
        return out
    lib = _library()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        launch = getattr(lib, "rank_pivots_launch" + _SUFFIX[dtype])
        code = launch(q.data_ptr(), targets.data_ptr(), pivot_cols.data_ptr(),
                      n, D, targets.shape[0], int(col_lo),
                      0 if score_map is None else score_map.code,
                      out.data_ptr(), stream)
    check_launch(code, "rank_pivots")
    rank_pivots.launches += 1
    return out


rank_pivots.launches = 0


def _check(q, targets, pivot, row_ptr, cols, num_valid, pivot_cols):
    n, D = q.shape
    if targets.dim() != 2 or targets.shape[1] != D:
        raise ValueError(f"targets {tuple(targets.shape)} do not match q {tuple(q.shape)}")
    if targets.dtype != q.dtype:
        raise TypeError(
            f"fused_rank_counts takes q and targets of one dtype, got "
            f"{q.dtype} and {targets.dtype}")
    if not 0 <= num_valid <= targets.shape[0]:
        raise ValueError(f"num_valid {num_valid} outside [0, {targets.shape[0]}]")
    if row_ptr.shape != (n + 1,) or cols.dim() != 1:
        raise ValueError("labels must be CSR: row_ptr [n+1], cols [nnz]")
    if (pivot is None) == (pivot_cols is None):
        raise ValueError("pass exactly one of pivot and pivot_cols")
    if pivot is not None and pivot.shape != (n,):
        raise ValueError(f"pivot must have shape ({n},)")
    if pivot_cols is not None and pivot_cols.shape != (n,):
        raise ValueError(f"pivot_cols must have shape ({n},)")


def fused_rank_counts(
    q: torch.Tensor,
    targets: torch.Tensor,
    pivot: Optional[torch.Tensor],
    row_ptr: torch.Tensor,
    cols: torch.Tensor,
    num_valid: int,
    atol: float,
    rtol: float,
    score_map=None,
    pivot_cols: Optional[torch.Tensor] = None,
    plan: Optional[Dict[str, int]] = None,
):
    """(greater [n] int32, close [n] int32, vals [nnz], pivot [n]); vals and
    pivot in q's dtype (float32, bfloat16 or float16).

    Scores are ``score_map(q @ targets.T)`` over the columns ``<
    num_valid``; counts are against the row's pivot under isclose tie
    semantics; ``vals`` holds the score at each CSR label column (0 where the
    column is ``>= num_valid``). ``score_map`` is None or a ``ScoreEpilogue``.
    Give either ``pivot`` [n] (in q's dtype) or ``pivot_cols`` [n], the
    column whose own score is the pivot. ``plan`` (of ``rank_plan``) sets
    the kernel's grid; the outputs do not depend on it.
    """
    if score_map is not None and not isinstance(score_map, ScoreEpilogue):
        raise NotImplementedError(
            f"fused_rank_counts: score_map {score_map!r} is not a named "
            "epilogue (ScoreEpilogue); the kernel applies only those"
        )
    _check(q, targets, pivot, row_ptr, cols, num_valid, pivot_cols)
    if q.device.type == "cpu":
        return fused_rank_counts_plain(
            q, targets, pivot, row_ptr, cols, num_valid, atol, rtol,
            score_map=score_map, pivot_cols=pivot_cols,
        )
    if q.device.type != "cuda":
        raise ValueError(f"fused_rank_counts: unsupported device {q.device}")
    return _launch(q, targets, row_ptr, cols, num_valid, atol, rtol,
                   pivot_cols, plan,
                   epilogue=0 if score_map is None else score_map.code,
                   pivot=pivot)


fused_rank_counts.launches = 0
#: the launches among them with a score epilogue other than the identity
fused_rank_counts.epilogue_launches = 0
#: the launches among them of the bfloat16 and of the float16 path
fused_rank_counts.bf16_launches = 0
fused_rank_counts.f16_launches = 0
#: the launches among them with a given pivot (a column shard's)
fused_rank_counts.sharded_launches = 0
#: int64 [1] on the card: the entries that the last bfloat16 or float16
#: launch's certificate left undecided (recomputed by the chain); None
#: before one
fused_rank_counts.last_recounted = None


def _library():
    from kge_tpu_torch.ops.kernel_utils import load_library

    lib = load_library(_KERNEL)
    if not getattr(lib, "_kge_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        launch = [p, p, p, p, p, p, i, i, i, i, f, f, i, i, p, p, p, p, p]
        pivots = [p, p, p, i, i, i, i, i, p, p]
        for name, args in (("rank_counts_launch", launch + [p]),
                           ("rank_counts_launch_bf16", launch + [p, p, i, p, p]),
                           ("rank_counts_launch_f16", launch + [p, p, i, p, p]),
                           ("rank_pivots_launch", pivots),
                           ("rank_pivots_launch_bf16", pivots),
                           ("rank_pivots_launch_f16", pivots),
                           ("rank_counts_tile_sums_bf16", [p, p, i, i, i, p, p, p]),
                           ("rank_counts_tile_sums_f16", [p, p, i, i, i, p, p, p])):
            getattr(lib, name).argtypes = args
            getattr(lib, name).restype = i
        for name in ("rank_counts_tile_cols", "rank_counts_tile_rows"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        if (lib.rank_counts_tile_rows(), lib.rank_counts_tile_cols()) != (
                TILE_ROWS, TILE_COLS):
            raise RuntimeError("rank_counts: the tile differs from the kernel's")
        lib._kge_typed = True
    return lib


def _launch(q, targets, row_ptr, cols, num_valid, atol, rtol, pivot_cols,
            plan=None, epilogue=0, pivot=None):
    from kge_tpu_torch.ops.kernel_utils import check_launch

    device = q.device
    dtype = q.dtype
    if dtype not in _SUFFIX:
        raise TypeError(f"fused_rank_counts: the kernel takes float32, "
                        f"bfloat16 or float16, got {dtype}")
    tensors = {"q": q, "targets": targets, "row_ptr": row_ptr, "cols": cols,
               "pivot_cols": pivot_cols, "pivot": pivot}
    wanted = {"q": dtype, "targets": dtype,
              "row_ptr": torch.int32, "cols": torch.int32,
              "pivot_cols": torch.int32, "pivot": dtype}
    for name, x in tensors.items():
        if x is None:
            continue
        if x.device != device:
            raise ValueError(f"fused_rank_counts: {name} is on {x.device}, q on {device}")
        if x.dtype != wanted[name]:
            raise TypeError(f"fused_rank_counts: {name} must be {wanted[name]}, got {x.dtype}")
        if not x.is_contiguous():
            raise ValueError(f"fused_rank_counts: {name} must be contiguous")
    lib = _library()
    n, D = q.shape
    if plan is None:
        plan = rank_plan(n, num_valid)
    elif ((plan["tile_rows"], plan["tile_cols"]) != (TILE_ROWS, TILE_COLS)
          or plan["num_tiles"] != -(-num_valid // TILE_COLS)):
        raise ValueError(f"fused_rank_counts: plan {plan} is not for {num_valid} columns")
    # the kernels write every element of the four outputs
    counts = torch.empty(2, n, dtype=torch.int32, device=device)
    vals = torch.empty(cols.numel(), dtype=dtype, device=device)
    pivot_out = torch.empty(n, dtype=dtype, device=device)
    if n == 0:
        return counts[0], counts[1], vals, pivot_out
    tile_ptr = torch.empty(n * (plan["num_tiles"] + 1), dtype=torch.int32,
                           device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        args = [
            q.data_ptr(), targets.data_ptr(),
            None if pivot_cols is None else pivot_cols.data_ptr(),
            None if pivot is None else pivot.data_ptr(),
            row_ptr.data_ptr(), cols.data_ptr(),
            n, D, int(num_valid), cols.numel(), float(atol), float(rtol),
            int(epilogue), plan["tiles_per_range"], tile_ptr.data_ptr(),
            counts[0].data_ptr(), counts[1].data_ptr(), vals.data_ptr(),
            pivot_out.data_ptr(),
        ]
        launch = getattr(lib, "rank_counts_launch" + _SUFFIX[dtype])
        if dtype == torch.float32:
            code = launch(*args, stream)
        else:
            # the certificate's norm bounds and each row's category cuts,
            # the recount launch's worklist, and the count of the entries it
            # left undecided with the worklist's fill (written by the kernels)
            norms = torch.empty(3 * n + int(num_valid), dtype=torch.float32,
                                device=device)
            capacity = min(n * int(num_valid), RECOUNT_CAPACITY)
            work = torch.empty(2 * max(capacity, 1), dtype=torch.int32,
                               device=device)
            counters = torch.empty(2, dtype=torch.int64, device=device)
            code = launch(*args, norms.data_ptr(), work.data_ptr(), capacity,
                          counters.data_ptr(), stream)
    check_launch(code, "rank_counts")
    fused_rank_counts.launches += 1
    fused_rank_counts.epilogue_launches += epilogue != 0
    fused_rank_counts.sharded_launches += pivot is not None
    fused_rank_counts.bf16_launches += dtype == torch.bfloat16
    fused_rank_counts.f16_launches += dtype == torch.float16
    if dtype != torch.float32:
        fused_rank_counts.last_recounted = counters[:1]
    return counts[0], counts[1], vals, pivot_out


#: what ``f16_subnormal_check`` counts, in the order of the kernel's counts
F16_SUBNORMAL_COUNTS = (
    "pairs_normal", "pairs_one_subnormal", "pairs_both_subnormal",
    "differ_normal", "differ_one_subnormal", "differ_both_subnormal", "flushed",
)


def f16_subnormal_check(device) -> dict:
    """How the tensor cores read float16, on the card, exhaustively
    (``csrc/rank_counts.cu`` ``f16_subnormal_check_kernel``): every ordered
    pair of float16 values (2^32) through ``mma.sync m16n8k16`` with one
    product an accumulator, against the exact float32 product. ``pairs_*``
    count the pairs with neither, one or both operands subnormal,
    ``differ_*`` those among them whose sum is not the product (equal
    values, or NaN on both sides), ``flushed`` the differing sums that are
    0 where the product is not. Not on any main path."""
    from kge_tpu_torch.ops.kernel_utils import check_launch, typed

    device = torch.device(device)
    if device.type != "cuda":
        raise ValueError(f"f16_subnormal_check runs on a CUDA card, not {device}")
    counts = torch.zeros(len(F16_SUBNORMAL_COUNTS), dtype=torch.int64,
                         device=device)
    launch = typed(_library(), "rank_counts_f16_subnormal_check",
                   [ctypes.c_void_p, ctypes.c_void_p])
    with torch.cuda.device(device):
        code = launch(counts.data_ptr(), torch.cuda.current_stream(device).cuda_stream)
    check_launch(code, "rank_counts_f16_subnormal_check")
    return dict(zip(F16_SUBNORMAL_COUNTS, counts.tolist()))


def tc_tile_sums(q: torch.Tensor, targets: torch.Tensor):
    """For checks of the certificate on the card: the tensor cores' float32
    sums ``q @ targets.T`` [n, m] of the bfloat16 or float16 kernel's own
    tile product (its instruction sequence, not a library's), and the norm
    bounds of its prologue for the rows of q [n] and of targets [m]. Not on
    any main path and not counted as a launch."""
    from kge_tpu_torch.ops.kernel_utils import check_launch, require

    device = q.device
    if device.type != "cuda":
        raise ValueError("tc_tile_sums runs the CUDA kernel only")
    if q.dtype not in _CHAINED:
        raise TypeError(f"tc_tile_sums takes bfloat16 or float16, got {q.dtype}")
    for name, x in (("q", q), ("targets", targets)):
        require(name, x, device, q.dtype)
    (n, D), m = q.shape, targets.shape[0]
    if targets.shape[1] != D:
        raise ValueError(f"targets {tuple(targets.shape)} do not match q {tuple(q.shape)}")
    sums = torch.empty(n, m, dtype=torch.float32, device=device)
    norms = torch.empty(n + m, dtype=torch.float32, device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        entry = "rank_counts_tile_sums" + _SUFFIX[q.dtype]
        code = getattr(_library(), entry)(
            q.data_ptr(), targets.data_ptr(), n, D, m, sums.data_ptr(),
            norms.data_ptr(), stream)
    check_launch(code, entry)
    return sums, norms[:n], norms[n:]
