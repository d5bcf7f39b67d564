"""Per-row column picks from a score matrix (kge_tpu/ops/pick.py).

``picked_scores(S, idx)`` is ``S[b, idx[b, k]]``: the op behind exact
per-row negative sampling (score against all entities, or against a batch's
distinct candidates, then take each row's sampled columns; reference
kge/util/sampler.py:263-356).

kge_tpu computes the pick with ``take_along_axis`` off the TPU
(``pick.py:45-47``) and, on the TPU, as a one-hot contraction that avoids
XLA's serial gather. That contraction is the TPU's tiling and is not
ported, and neither is ``picked_scores_grouped`` with its [n, G, 128]
layout: the port's score matrices are flat [n, V].

Here the forward is ``torch.gather`` and the backward is written out as a
``torch.autograd.Function``: with-replacement sampling picks one column of a
row several times, and torch's own gather backward sums such repeats with
float atomics on CUDA, in an order that changes from launch to launch. The
backward here is ``index_put_(..., accumulate=True)`` into a zero [n, V]
matrix: on CUDA that path sorts the linear indices with a stable radix sort
and sums each index's duplicates in the sorted (so the original) order, so
two launches give the same bits, one order for every output element as the
package's kernels keep. On the CPU it is a sequential loop in index order.

Under a model axis a rank holds its columns of the score matrix only
(parallel/mesh.py): ``picked_scores_columns`` picks each row's columns on
the rank that holds them, -0.0 on the others, and sums the picks over the
model group, so every rank holds the whole [n, K] picks.
"""

from __future__ import annotations

import torch


class _PickedScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, S, idx):
        ctx.save_for_backward(idx)
        ctx.shape = S.shape
        return torch.gather(S, 1, idx)

    @staticmethod
    def backward(ctx, grad):
        (idx,) = ctx.saved_tensors
        n, V = ctx.shape
        dS = torch.zeros((n, V), dtype=grad.dtype, device=grad.device)
        rows = torch.arange(n, device=idx.device)[:, None].expand_as(idx)
        dS.index_put_((rows, idx), grad, accumulate=True)
        return dS, None


def picked_scores_columns(S: torch.Tensor, idx: torch.Tensor, lo: int,
                          mesh) -> torch.Tensor:
    """``picked_scores`` of the whole row where ``S`` [n, m] holds a rank's
    columns ``[lo, lo + m)`` of it: the rank that holds a column gives its
    value, the others -0.0, the neutral element of the model group's sum
    (``ModelSum``: identity backward, so each rank's gradient reaches its
    own columns)."""
    from kge_tpu_torch.parallel.mesh import ModelSum

    local = idx.long() - lo
    own = (local >= 0) & (local < S.shape[1])
    got = picked_scores(S, torch.where(own, local, 0))
    got = torch.where(own, got, torch.full((), -0.0, dtype=got.dtype,
                                           device=got.device))
    return ModelSum.apply(got, mesh)


def picked_scores(S: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``take_along_axis(S, idx, axis=1)``: S [n, V] scores, idx [n, K]
    columns in [0, V); returns [n, K] in S's dtype, with a backward whose
    sums of repeated columns are bit-equal across launches."""
    return _PickedScores.apply(S, idx.long())
