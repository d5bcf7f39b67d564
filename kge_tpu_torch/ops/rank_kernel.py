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
input). The grid is (row tiles) x (column ranges): ``rank_plan`` cuts the
candidate columns into ranges of whole tiles (one tile each: many short
blocks balance the SMs best), and the blocks of
a row tile add their int32 counts with ``atomicAdd``, exact in any order, so
the outputs are bit-equal across launches and across plans. Measured by
``chip_smoke.py`` on an NVIDIA H100 80GB HBM3 (700 W) at n = 256,
|E| = 14,541, D = 512: about 0.135 ms a call, against a bound of 0.057 ms
and 0.28 ms for ``torch.matmul`` and the compares (PERF.md has the table).

Beside the kernel stand its plain PyTorch version (``fused_rank_counts_plain``,
the path for tensors on the CPU and the kernel's oracle on the card) and a
launch counter (``fused_rank_counts.launches``). A CUDA tensor goes to the
kernel or the wrapper raises; no path falls back to the plain version.

Differences from the TPU kernel's interface, both for the card:

- Labels come per row in CSR form (``row_ptr [n+1]``, ``cols`` ascending and
  unique within each row) and ``vals`` is aligned with ``cols``; some
  FB15k-237 queries have thousands of answers, which a padded [n, kmax]
  block would multiply by n.
- ``pivot_cols`` asks for the pivot to be the row's own score at that
  column, computed with the same float32 FMA chain as the tile, so the true
  entity ties with itself exactly. The pivot used is returned. The kernel
  takes the pivot only this way; an explicit ``pivot``, as the TPU kernel
  takes it, is for CPU tensors (the plain version).

Precision is float32 throughout (the TPU kernel rounds its inputs to bf16):
every score is one FMA chain over the embedding dimension in ascending
order, whatever the plan. ``score_map`` epilogues (the sqrt of L2 distance
scorers) are not supported.
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional, Tuple

import torch

_KERNEL = "rank_counts"
#: candidate columns per tile of the kernel (BN of csrc/rank_counts.cu)
TILE_COLS = 128
#: query rows per block of the kernel (BM of csrc/rank_counts.cu)
TILE_ROWS = 64


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
    is_close = (scores - true).abs() <= atol + rtol * true.abs()
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


def fused_rank_counts_plain(q, targets, pivot, row_ptr, cols, num_valid: int,
                            atol: float, rtol: float, score_map=None,
                            pivot_cols=None):
    """The plain PyTorch version: materializes the [n, num_valid] scores."""
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


def _check(q, targets, pivot, row_ptr, cols, num_valid, pivot_cols):
    n, D = q.shape
    if targets.dim() != 2 or targets.shape[1] != D:
        raise ValueError(f"targets {tuple(targets.shape)} do not match q {tuple(q.shape)}")
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
    """(greater [n] int32, close [n] int32, vals [nnz] float32, pivot [n]).

    Scores are ``q @ targets.T`` over the columns ``< num_valid``; counts
    are against the row's pivot under isclose tie semantics; ``vals`` holds
    the score at each CSR label column (0 where the column is ``>=
    num_valid``). Give either ``pivot`` [n] or ``pivot_cols`` [n], the
    column whose own score is the pivot; on the card only ``pivot_cols``.
    ``plan`` (of ``rank_plan``) sets the kernel's grid; the outputs do not
    depend on it.
    """
    if score_map is not None:
        raise NotImplementedError(
            "fused_rank_counts: score epilogues (L2 distance scorers) are not "
            "ported yet; see ROADMAP.md"
        )
    _check(q, targets, pivot, row_ptr, cols, num_valid, pivot_cols)
    if q.device.type == "cpu":
        return fused_rank_counts_plain(
            q, targets, pivot, row_ptr, cols, num_valid, atol, rtol,
            pivot_cols=pivot_cols,
        )
    if q.device.type != "cuda":
        raise ValueError(f"fused_rank_counts: unsupported device {q.device}")
    if pivot_cols is None:
        raise ValueError(
            "fused_rank_counts: the CUDA kernel takes the pivot from "
            "pivot_cols, not as an explicit pivot"
        )
    return _launch(q, targets, row_ptr, cols, num_valid, atol, rtol,
                   pivot_cols, plan)


fused_rank_counts.launches = 0


def _library():
    from kge_tpu_torch.ops.kernel_utils import load_library

    lib = load_library(_KERNEL)
    if not getattr(lib, "_kge_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rank_counts_launch.argtypes = [
            p, p, p, p, p, i, i, i, i, f, f, i, p, p, p, p, p, p,
        ]
        lib.rank_counts_launch.restype = i
        for name in ("rank_counts_tile_cols", "rank_counts_tile_rows"):
            getattr(lib, name).argtypes = []
            getattr(lib, name).restype = i
        if (lib.rank_counts_tile_rows(), lib.rank_counts_tile_cols()) != (
                TILE_ROWS, TILE_COLS):
            raise RuntimeError("rank_counts: the tile differs from the kernel's")
        lib._kge_typed = True
    return lib


def _launch(q, targets, row_ptr, cols, num_valid, atol, rtol, pivot_cols,
            plan=None):
    from kge_tpu_torch.ops.kernel_utils import check_launch

    device = q.device
    tensors = {"q": q, "targets": targets, "row_ptr": row_ptr, "cols": cols,
               "pivot_cols": pivot_cols}
    wanted = {"q": torch.float32, "targets": torch.float32,
              "row_ptr": torch.int32, "cols": torch.int32,
              "pivot_cols": torch.int32}
    for name, x in tensors.items():
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
    vals = torch.empty(cols.numel(), dtype=torch.float32, device=device)
    pivot_out = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return counts[0], counts[1], vals, pivot_out
    tile_ptr = torch.empty(n * (plan["num_tiles"] + 1), dtype=torch.int32,
                           device=device)
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.rank_counts_launch(
            q.data_ptr(), targets.data_ptr(), pivot_cols.data_ptr(),
            row_ptr.data_ptr(), cols.data_ptr(),
            n, D, int(num_valid), cols.numel(), float(atol), float(rtol),
            plan["tiles_per_range"], tile_ptr.data_ptr(),
            counts[0].data_ptr(), counts[1].data_ptr(), vals.data_ptr(),
            pivot_out.data_ptr(), stream,
        )
    check_launch(code, "rank_counts")
    fused_rank_counts.launches += 1
    return counts[0], counts[1], vals, pivot_out
