"""The ring schedule of full-vocabulary scoring over the model axis.

The port of kge_tpu/parallel/ring.py. With the entity table row-sharded
over the model group (parallel/mesh.py), scoring a batch against all
entities (1vsAll, KvsAll, negative sampling's ``all``) needs each row's
query, built from the entity row that one rank holds, on every rank of the
group. The unfused schedule gathers the rows first (the lookup's sum over
the group) and then multiplies the query by the rank's own targets. Every
factorizing scorer's query is linear in the gathered entity row (DistMult
``s * p``, ComplEx's complex product, RESCAL ``s @ M_p``, CP's and SimplE's
half products: models/factorization.py), so the sum can instead run inside
the product, as a ring:

    every rank m builds the query PART from the rows it holds (-0.0
    elsewhere, as the lookups do); for M - 1 steps each rank multiplies
    the part it holds by its own targets, adds the product to its columns
    and passes the part on to the next rank of the group while it receives
    one from the previous rank (``distributed.exchange``); after the last
    step its columns are (sum of the parts) @ targets^T.

Each row's part is non-zero on exactly one rank, so every other term of a
row is a product of zeros and the ring's columns equal the unfused
schedule's bit for bit.

The backward pass is written out (``_RingScores``): the gradient of every
part is the same, the sum over the group of ``dS_local @ targets_local``,
taken by one all-reduce over the model group (not kge_tpu's reverse ring,
which JAX derives from the forward ring); the target table's gradient is
``dS_local^T @ q``, ``q`` the sum of the parts the rank saw, chained through
``map_targets``; the gradient of the rows each part was built from reaches
the rank's own table rows through the lookup's backward (the scatter
kernel); the relation rows' gradient, which each rank's part holds only for
the entity rows that rank holds, is summed over the group.
"""

from __future__ import annotations

from typing import Callable

import torch

from kge_tpu_torch.parallel import distributed


class _RingScores(torch.autograd.Function):
    @staticmethod
    def forward(ctx, table, row_ctx, ids, lo, mesh, make_query, map_targets):
        ctx.lo, ctx.mesh = lo, mesh
        ctx.make_query, ctx.map_targets = make_query, map_targets
        qpart = make_query(_own_rows(table, ids, lo), row_ctx)
        targets = map_targets(table)
        scores = qpart @ targets.T
        seen = qpart.clone()
        model, index = mesh.model, mesh.model_index
        first = mesh.data_index * model
        send_to = first + (index + 1) % model
        recv_from = first + (index - 1) % model
        part = qpart
        for _ in range(model - 1):
            part = distributed.exchange(part, send_to, recv_from, mesh.model_group)
            scores = scores + part @ targets.T
            seen = seen + part
        ctx.save_for_backward(table, row_ctx, ids, seen)
        return scores

    @staticmethod
    def backward(ctx, grad):
        table, row_ctx, ids, seen = ctx.saved_tensors
        mesh = ctx.mesh
        with torch.enable_grad():
            table_ = table.detach().requires_grad_(ctx.needs_input_grad[0])
            row_ctx_ = row_ctx.detach().requires_grad_(ctx.needs_input_grad[1])
            targets = ctx.map_targets(table_)
            # every part met every rank's targets: its gradient is the sum
            # over the group of each rank's dS @ targets (one all-reduce)
            grad_part = mesh.model_sum((grad @ targets.detach()).contiguous())
            grad_targets = grad.T @ seen
            qpart = ctx.make_query(_own_rows(table_, ids, ctx.lo), row_ctx_)
            inputs = [t for t in (table_, row_ctx_) if t.requires_grad]
            got = torch.autograd.grad(
                [qpart, targets], inputs, [grad_part, grad_targets],
                allow_unused=True,
            ) if inputs else []
        got = iter(got)
        grad_table = next(got) if ctx.needs_input_grad[0] else None
        grad_row_ctx = next(got) if ctx.needs_input_grad[1] else None
        if grad_row_ctx is not None:
            # this rank's part holds the relation rows' gradient of its own
            # entity rows only
            grad_row_ctx = mesh.model_sum(grad_row_ctx.contiguous())
        return grad_table, grad_row_ctx, None, None, None, None, None


def _own_rows(table: torch.Tensor, ids: torch.Tensor, lo: int) -> torch.Tensor:
    """The table rows at ``ids`` that this rank holds (``table`` holds rows
    ``lo`` on), -0.0 at the others, as ``LookupEmbedder.lookup`` takes
    them; the gather's backward is the scatter kernel when the job selects
    it."""
    from kge_tpu_torch.ops.embedding_ops import embedding_gather

    local = ids.long() - lo
    own = (local >= 0) & (local < table.shape[0])
    rows = embedding_gather(table, torch.where(own, local, 0))
    return torch.where(own.unsqueeze(-1), rows,
                       torch.full((), -0.0, dtype=rows.dtype, device=rows.device))


def ring_all_scores(
    mesh,
    table_local: torch.Tensor,
    ids: torch.Tensor,
    row_ctx: torch.Tensor,
    make_query: Callable,
    map_targets: Callable,
    lo: int,
) -> torch.Tensor:
    """This rank's columns [n, |E| / M] of ``make_query(E[ids], row_ctx) @
    map_targets(E)^T``, with ``table_local`` the entity rows this rank holds
    (from row ``lo`` on), ``ids`` and ``row_ctx`` the batch rows of its data
    coordinate, as the ring over the model group. ``make_query(rows,
    row_ctx) -> [n, d']`` must be linear in ``rows``; ``map_targets`` maps
    the table's rows to targets. Each call adds one to
    ``ring_all_scores.calls``."""
    ring_all_scores.calls += 1
    return _RingScores.apply(table_local, row_ctx, ids, lo, mesh, make_query,
                             map_targets)


ring_all_scores.calls = 0
