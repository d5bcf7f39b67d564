"""The (data, model) device mesh over ranks.

The port of kge_tpu/parallel/mesh.py. kge_tpu lays its devices out as a 2-D
mesh ``(data, model)``: batches shard over ``data``, the entity table's
rows over ``model``, and GSPMD inserts the collectives. Here every device
is a rank of ``torch.distributed`` (parallel/distributed.py), laid out
row-major as ``np.array(ranks).reshape(data, model)``, so rank ``r`` sits at
``divmod(r, model)``. The ranks of one mesh row share their batch rows and
hold the entity table between them (the row's *model group*); the ranks of
one mesh column hold the same entity rows and split the batch (the
column's *data group*). Every rank creates every group, in one order.

Only the entity table (and, with it, its optimizer state) is row-sharded
(``param_spec``); everything else is replicated. A rank holds the entity
rows ``[lo, hi)`` of its model coordinate and ranks the batch rows of its
data coordinate (``batch_rows``). With one rank every spec is replicated
and the context is inactive.

Two operators carry gradients across the model group (Megatron-LM's "g"
and "f"). ``ModelSum`` sums a tensor over the group in the forward pass
and is the identity in the backward pass: a row shard's lookups, and the
sums of a rank's columns into a row's total, whose result every rank of
the group uses alike. ``ModelCopy`` is the identity in the forward pass
and sums the gradient over the group in the backward pass: a tensor that
every rank holds alike (a query, relation rows, a scorer's parameters)
where it meets the rank's own columns of a score matrix, each rank's part
of its gradient coming from its columns only. With both, every rank of a
group computes the same loss, and every replicated tensor's gradient is
one process's (up to the order of the sums). ``DataSum`` sums over the data
group in both passes: the batch statistics of ConvE's batch norm
(models/neural.py), taken over every rank's rows of the batch.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import torch

from kge_tpu_torch.parallel import distributed

#: groups of each mesh shape, created once per process: (data, model) ->
#: (model groups by data coordinate, data groups by model coordinate)
_GROUPS: Dict[Tuple[int, int], Tuple[list, list]] = {}
#: mesh shapes already logged by rank 0
_LOGGED = set()


class DeviceCtx:
    """This rank's place in the (data, model) mesh and its groups."""

    def __init__(self, data: int = 1, model: int = 1, rank: int = 0,
                 data_group=None, model_group=None):
        self.data, self.model = data, model
        self.rank = rank
        self.data_index, self.model_index = divmod(rank, model)
        self.data_group, self.model_group = data_group, model_group

    @property
    def active(self) -> bool:
        return self.data * self.model > 1

    @property
    def num_devices(self) -> int:
        return self.data * self.model

    @staticmethod
    def create(config, batch_divisor: Optional[int] = None) -> "DeviceCtx":
        """The mesh of ``parallel.data`` x ``parallel.model`` over the ranks
        of this run, with kge_tpu's rules: ``model <= 0`` is 1, ``data <=
        0`` (auto) is the ranks over ``model``, shrunk until it divides
        ``batch_divisor`` (the batch size). A mesh needs exactly the run's
        ranks: more raises kge_tpu's message, fewer leaves a rank without a
        place."""
        distributed.maybe_initialize(config)
        n = distributed.world_size()
        data = int(config.get("parallel.data"))
        model = int(config.get("parallel.model"))
        if model <= 0:
            model = 1
        if data <= 0:
            data = max(n // model, 1)
            if batch_divisor is not None:
                while data > 1 and batch_divisor % data != 0:
                    data -= 1
        if data * model > n:
            raise ValueError(
                f"mesh {data}x{model} needs {data * model} devices, have {n}"
            )
        if data * model < n:
            raise ValueError(
                f"mesh {data}x{model} holds {data * model} of the {n} "
                "processes; every process needs a place in the mesh"
            )
        if n == 1:
            return DeviceCtx()
        rank = distributed.process_index()
        model_groups, data_groups = _groups(data, model)
        ctx = DeviceCtx(data, model, rank, data_groups[rank % model],
                        model_groups[rank // model])
        if (data, model) not in _LOGGED:
            _LOGGED.add((data, model))
            config.log(
                f"Mesh {data}x{model} (data x model) over {n} processes, "
                f"backend {distributed.backend}"
                + (" (ranks share a card, which NCCL refuses; the ring's "
                   "point-to-point steps stage through host memory, since "
                   "gloo sends CPU tensors only)"
                   if distributed.shared_card else "")
            )
            placed = distributed.placement_line()
            if placed:
                config.log(placed)
        return ctx

    # -- sharding ------------------------------------------------------------

    @staticmethod
    def param_spec(path_key: str) -> Optional[str]:
        """"model" for the leaves whose rows shard over the model axis (the
        entity table, by its path in kge_tpu's parameter tree), None for
        replicated ones."""
        if "entity_embedder" in path_key and path_key.endswith("embeddings"):
            return "model"
        return None

    def entity_rows(self, num_entities: int) -> Tuple[int, int]:
        """The entity rows ``[lo, hi)`` this rank holds."""
        per = num_entities // self.model
        return self.model_index * per, (self.model_index + 1) * per

    def batch_rows(self, n: int) -> Tuple[int, int]:
        """The rows ``[start, stop)`` of an ``n``-row batch this rank takes."""
        per = n // self.data
        return self.data_index * per, (self.data_index + 1) * per

    def reduce_data(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` in place over the data group."""
        if self.data > 1:
            distributed.all_reduce(tensor, self.data_group)
        return tensor

    def reduce_model(self, tensor: torch.Tensor) -> torch.Tensor:
        """Sum ``tensor`` in place over the model group."""
        if self.model > 1:
            distributed.all_reduce(tensor, self.model_group)
        return tensor

    def model_sum(self, values: torch.Tensor) -> torch.Tensor:
        """``values`` summed over the model group, as a new tensor of their
        dtype; floats narrower than float32 are summed in float32, exact
        where one rank's term is not -0.0, the neutral element of the sum
        (a row shard's lookups, ``rank_pivots``)."""
        narrow = values.dtype in (torch.bfloat16, torch.float16)
        out = values.float() if narrow else values.clone()
        return self.reduce_model(out).to(values.dtype)

    def model_max(self, values: torch.Tensor) -> torch.Tensor:
        """The elementwise maximum of ``values`` over the model group, as a
        new tensor without gradient."""
        out = values.detach().clone()
        if self.model > 1:
            distributed.all_reduce_max(out, self.model_group)
        return out

    def sum_columns(self, values: torch.Tensor) -> torch.Tensor:
        """[n] sums of the rows of ``values`` [n, columns of this rank] over
        every rank's columns (``ModelSum``): the same on every rank of the
        group, each rank's gradient that of its own columns."""
        return ModelSum.apply(torch.sum(values, dim=1), self)

    def logsumexp_columns(self, values: torch.Tensor) -> torch.Tensor:
        """[n] logsumexp of each row over every rank's columns: the rows'
        maximum over the group (without gradient), then the sum of the
        exponentials over the group; each rank's gradient is the softmax on
        its own columns."""
        top = self.model_max(torch.max(values, dim=1).values)
        top = torch.where(torch.isfinite(top), top, torch.zeros_like(top))
        total = self.sum_columns(torch.exp(values - top[:, None]))
        return top + torch.log(total)

    def gather_data(self, piece: torch.Tensor) -> torch.Tensor:
        """The pieces of the data group stacked on a new first axis, in
        data-coordinate order."""
        return distributed.all_gather(piece, self.data, self.data_group)


class ModelSum(torch.autograd.Function):
    """Sum over the mesh's model group in the forward pass
    (``DeviceCtx.model_sum``), identity in the backward pass: every rank of
    the group computes the same loss from the sum, so each holds the whole
    gradient of it."""

    @staticmethod
    def forward(ctx, x, mesh):
        return mesh.model_sum(x)

    @staticmethod
    def backward(ctx, grad):
        return grad, None


class ModelCopy(torch.autograd.Function):
    """The conjugate of ``ModelSum``: identity in the forward pass, the
    gradient summed over the mesh's model group in the backward pass. A
    tensor that every rank of the group holds alike passes it where it meets
    the rank's own columns: each rank's gradient of it is the share of its
    columns, and the sum is the whole gradient, the same on every rank."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.model_sum(grad.contiguous()), None


class DataSum(torch.autograd.Function):
    """Sum over the mesh's data group in both passes (SyncBatchNorm's rule):
    a statistic of the whole batch from each rank's sums over its rows. Each
    rank's loss is its rows' share of the batch's, and every rank's rows
    feed the statistic, so a rank's gradient of it is the sum of every
    rank's; the dense step's data-group sum of the parameter gradients then
    gives one process's gradient."""

    @staticmethod
    def forward(ctx, x, mesh):
        ctx.mesh = mesh
        return mesh.reduce_data(x.clone())

    @staticmethod
    def backward(ctx, grad):
        return ctx.mesh.reduce_data(grad.clone()), None


def _groups(data: int, model: int):
    """The model group of every mesh row and the data group of every mesh
    column, created by every rank in this order."""
    import torch.distributed as dist

    if (data, model) not in _GROUPS:
        rows = [dist.new_group([d * model + m for m in range(model)])
                for d in range(data)]
        cols = [dist.new_group([d * model + m for d in range(data)])
                for m in range(model)]
        _GROUPS[(data, model)] = (rows, cols)
    return _GROUPS[(data, model)]


def entity_shard(config, num_entities: int):
    """(lo, hi, ctx) of this rank's entity rows where the mesh's model axis
    is above 1, else None. Raises kge_tpu's message where the entity count
    does not divide."""
    if int(config.get("parallel.model")) <= 1:
        return None
    ctx = DeviceCtx.create(config)
    if ctx.model <= 1:
        return None
    if num_entities % ctx.model != 0:
        raise ValueError(
            f"num_entities={num_entities} must be divisible by the model "
            f"mesh axis ({ctx.model}) for row-sharded entity tables "
            "(pad the vocabulary or adjust parallel.model)"
        )
    lo, hi = ctx.entity_rows(num_entities)
    return lo, hi, ctx
