"""Fused filtered-rank counts: score block, tie counts and label values
without holding the batch x |E| score matrix.

Replaces the TPU kernel ``kge_tpu/ops/rank_kernel.py`` ``fused_rank_counts``
(Pallas body ``_kernel``, tie rule ``_close_greater``) with the CUDA C++
kernel ``csrc/rank_counts.cu``. What bounds it on an H100 and what its
design does about that is noted in the CUDA source: at evaluation shapes the
fp32 CUDA-core rate bounds it (about 60 flops per byte of input); one block
owns a tile of query rows and walks all candidate columns, so counts reduce
inside the block with no atomics.

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

Precision is float32 throughout (the TPU kernel rounds its inputs to bf16).
``score_map`` epilogues (the sqrt of L2 distance scorers) are not supported.
"""

from __future__ import annotations

import ctypes
from typing import Optional, Tuple

import torch

_KERNEL = "rank_counts"


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
):
    """(greater [n] int32, close [n] int32, vals [nnz] float32, pivot [n]).

    Scores are ``q @ targets.T`` over the columns ``< num_valid``; counts
    are against the row's pivot under isclose tie semantics; ``vals`` holds
    the score at each CSR label column (0 where the column is ``>=
    num_valid``). Give either ``pivot`` [n] or ``pivot_cols`` [n], the
    column whose own score is the pivot; on the card only ``pivot_cols``.
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
                   pivot_cols)


fused_rank_counts.launches = 0


def _library():
    from kge_tpu_torch.ops.kernel_utils import load_library

    lib = load_library(_KERNEL)
    if not getattr(lib, "_kge_typed", False):
        p, i, f = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.rank_counts_launch.argtypes = [
            p, p, p, p, p, i, i, i, f, f, p, p, p, p, p,
        ]
        lib.rank_counts_launch.restype = i
        lib.rank_counts_max_dim.argtypes = []
        lib.rank_counts_max_dim.restype = i
        lib._kge_typed = True
    return lib


def _launch(q, targets, row_ptr, cols, num_valid, atol, rtol, pivot_cols):
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
    max_dim = lib.rank_counts_max_dim()
    if D > max_dim:
        raise ValueError(
            f"fused_rank_counts: D={D} exceeds the kernel's shared-memory "
            f"limit of {max_dim}"
        )
    greater = torch.empty(n, dtype=torch.int32, device=device)
    close = torch.empty(n, dtype=torch.int32, device=device)
    vals = torch.zeros(cols.numel(), dtype=torch.float32, device=device)
    pivot_out = torch.empty(n, dtype=torch.float32, device=device)
    if n == 0:
        return greater, close, vals, pivot_out
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device).cuda_stream
        code = lib.rank_counts_launch(
            q.data_ptr(), targets.data_ptr(), pivot_cols.data_ptr(),
            row_ptr.data_ptr(), cols.data_ptr(),
            n, D, int(num_valid), float(atol), float(rtol),
            greater.data_ptr(), close.data_ptr(), vals.data_ptr(),
            pivot_out.data_ptr(), stream,
        )
    check_launch(code, "rank_counts_kernel")
    fused_rank_counts.launches += 1
    return greater, close, vals, pivot_out
