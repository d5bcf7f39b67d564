"""Model core: embedders, scorers, and the KGE model API.

The port of kge_tpu/models/base.py in PyTorch's idiom: models, scorers and
embedders are ``nn.Module``s whose parameters are tensors on an explicit
device, and scoring functions read them from the module (kge_tpu passes a
parameter pytree to pure functions instead). The scoring API keeps the
reference's names and combine semantics (score_spo/score_sp/score_po/
score_sp_po with "spo"/"sp_"/"_po", kge_model.py:122-213,663-789).
Randomness comes from explicit ``torch.Generator``s.

Ported so far: lookup and projection embedders (``ProjectionEmbedder``,
``Tucker3RelationEmbedder``), scorers with parameters of their own (the
neural models: ``RelationalScorer.param_tree`` and the batch-norm
statistics collector ``KgeModel.collect_stats``), and what filtered
entity-ranking evaluation and negative-sampling, 1vsAll and KvsAll
training need, kge_tpu's dtype policy (``parallel.param_dtype`` /
``parallel.compute_dtype``, utils/dtypes.py) and pretrained initialization
(``<embedder>.pretrain``). Under a (data, model) mesh of ranks
(parallel/mesh.py) the entity table is row-sharded over the model axis
(``LookupEmbedder``): scores against the whole vocabulary (``score_sp`` /
``score_po`` without candidates) are the rank's own columns, through
kge_tpu's ring schedule (parallel/ring.py) where its rule engages it
(``_ring_score``), else through the scorer with ``ModelCopy`` on what every
rank holds alike (``_score_columns``).

Where kge_tpu swaps gathered mini-tables into the parameter tree for the
row-sparse training step, the embedders here own their tables, so ``embed``
and the scoring functions take the substitute explicitly (``table=`` /
``tables=``): a tensor used in place of the embedder's own table for that
call. No table-sized gradient exists on that step.
"""

from __future__ import annotations

import contextlib
import math
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from kge_tpu_torch import misc
from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.parallel.mesh import ModelCopy, ModelSum
from kge_tpu_torch.utils.dtypes import promote, torch_dtype, weak

S, P, O = 0, 1, 2


# -- initializer dispatch ------------------------------------------------------


def _fans(shape) -> Tuple[int, int]:
    """fan_in/fan_out with torch.nn.init conventions ([out, in] 2D layout)."""
    if len(shape) < 2:
        fan = int(np.prod(shape))
        return fan, fan
    receptive = int(np.prod(shape[2:])) if len(shape) > 2 else 1
    return shape[1] * receptive, shape[0] * receptive


def make_initializer(initialize: str, initialize_args: Dict[str, Any]):
    """Map a torch.nn.init-style name + args to an in-place init
    ``fn(tensor, generator, shape=None)``; ``shape``, where given, is that
    of the whole tensor of which ``tensor`` is a block (the scale of xavier
    and kaiming depends on it). The automatic ``a = -b`` rule for uniform_
    is applied by the caller (``KgeBase.initializer``)."""
    args = dict(initialize_args or {})
    args.pop("+++", None)

    def uniform(t, g, a, b):
        return t.uniform_(a, b, generator=g)

    if initialize == "normal_":
        mean = float(args.get("mean", 0.0))
        std = float(args.get("std", 1.0))
        return lambda t, g, shape=None: t.normal_(mean, std, generator=g)
    elif initialize == "uniform_":
        a = float(args.get("a", 0.0))
        b = float(args.get("b", 1.0))
        return lambda t, g, shape=None: uniform(t, g, a, b)
    elif initialize == "xavier_uniform_":
        gain = float(args.get("gain", 1.0))

        def init(t, g, shape=None):
            fan_in, fan_out = _fans(shape or t.shape)
            bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
            return uniform(t, g, -bound, bound)

        return init
    elif initialize == "xavier_normal_":
        gain = float(args.get("gain", 1.0))

        def init(t, g, shape=None):
            fan_in, fan_out = _fans(shape or t.shape)
            return t.normal_(0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)),
                             generator=g)

        return init
    elif initialize == "kaiming_uniform_":
        a = float(args.get("a", 0.0))

        def init(t, g, shape=None):
            fan_in, _ = _fans(shape or t.shape)
            bound = math.sqrt(2.0 / (1 + a ** 2)) * math.sqrt(3.0 / fan_in)
            return uniform(t, g, -bound, bound)

        return init
    elif initialize == "constant_":
        val = float(args.get("val", 0.0))
        return lambda t, g, shape=None: t.fill_(val)
    elif initialize == "ones_":
        return lambda t, g, shape=None: t.fill_(1.0)
    elif initialize == "zeros_":
        return lambda t, g, shape=None: t.zero_()
    raise ValueError(f"invalid initializer: {initialize}")


class KgeBase(nn.Module, Configurable):
    """Base for models, scorers, and embedders: config + dataset + init."""

    def __init__(self, config: Config, dataset: Dataset, configuration_key=None):
        nn.Module.__init__(self)
        Configurable.__init__(self, config, configuration_key)
        self.dataset = dataset
        self.meta: Dict[str, Any] = dict()

    def initializer(
        self, config: Config = None, configuration_key: str = None
    ) -> Callable:
        """The initializer configured under ``initialize``/``initialize_args``
        (reference dispatch, kge_model.py:54-80): ``initialize_args.<name>``
        when present, else all of ``initialize_args``; ``a = -b`` for
        uniform_ when ``a`` is absent."""
        configurable = Configurable(
            config or self.config, configuration_key or self.configuration_key
        )
        initialize = configurable.get_option("initialize")
        try:
            initialize_args = configurable.get_option("initialize_args." + initialize)
        except KeyError:
            initialize_args = configurable.get_option("initialize_args")
        if isinstance(initialize_args, dict):
            initialize_args = {
                k: v for k, v in initialize_args.items() if k != "+++"
            }
        else:
            initialize_args = {}
        if initialize == "uniform_" and "a" not in initialize_args:
            if "b" not in initialize_args:
                initialize_args["b"] = 1.0
            initialize_args["a"] = -initialize_args["b"]
        return make_initializer(initialize, initialize_args)

    def prepare_job(self, job, **kwargs):
        """Register model-specific hooks on a job."""

    #: the generator of dropout masks, set by the training job
    dropout_generator: Optional[torch.Generator] = None
    #: (first row, rows, batch rows) of the batch rows whose loss this rank
    #: computes under a data axis, set by the training job at each step
    #: (job/train.py ``_enter_step``); None for the whole batch
    dropout_rows: Optional[Tuple[int, int, int]] = None
    #: the mesh whose data group holds the batch's other rows, set with
    #: ``dropout_rows`` (batch statistics sum over that group)
    batch_mesh = None

    def _dropout(self, x: torch.Tensor, rate: Optional[float] = None,
                 whole: bool = False,
                 vocab: Optional[Tuple[int, int]] = None) -> torch.Tensor:
        """Inverted dropout (torch.nn.Dropout semantics, elementwise) at
        ``rate`` (default ``self.dropout``) in train mode, drawn from
        ``dropout_generator``. Under ``dropout_rows``, a tensor of the
        batch's rows (leading size m times the rank's rows) takes its rows
        of the mask drawn for the whole batch, and one that serves the
        whole batch (``whole``: candidate lists, the whole vocabulary) the
        whole mask, so that every rank draws what one process draws. A row
        shard's vocabulary (``vocab``: its first row and the vocabulary's
        size) takes its rows of the mask drawn for the whole vocabulary."""
        rate = self.dropout if rate is None else rate
        if not self.training or rate <= 0.0:
            return x
        keep = 1.0 - rate
        shape, rows = tuple(x.shape), None
        if vocab is not None:
            lo, total = vocab
            rows = slice(lo, lo + shape[0])
            shape = (total,) + shape[1:]
        elif self.dropout_rows is not None and not whole:
            offset, local, total = self.dropout_rows
            if shape[0] % local != 0:
                raise ValueError(
                    f"dropout of a [{shape[0]}, ...] tensor in a step over "
                    f"{local} of {total} batch rows: its rows are not the "
                    "batch's"
                )
            m = shape[0] // local
            rows = slice(offset * m, (offset + local) * m)
            shape = (total * m,) + shape[1:]
        mask = torch.rand(
            shape, generator=self.dropout_generator, device=x.device
        ) < keep
        if rows is not None:
            mask = mask[rows]
        return torch.where(mask, x / weak(keep, x), torch.zeros_like(x))


# -- scorers -------------------------------------------------------------------


class RelationalScorer(KgeBase):
    """Scores (s, p, o) embedding combinations.

    ``score_emb(s, p, o, combine)``:

    - combine="spo": s, p, o are [n, d*]; result [n, 1]
    - combine="sp_": s, p are [n, d*], o is [m, d*]; result [n, m]
    - combine="_po": p, o are [n, d*], s is [m, d*]; result [n, m]
    - combine="s_o": s, o are [n, d*], p is [m, d*]; result [n, m]

    The generic form materializes all pairs and delegates to "spo"
    (reference kge_model.py:150-213); concrete scorers override the combines
    they can write as one product.

    A scorer with parameters of its own (the neural models) holds them as
    ``nn.Parameter``s and its batch-norm statistics as buffers, gives them
    as kge_tpu's ``params["scorer"]`` tree (``param_tree``) and draws them
    in ``init_params``. In train mode a stateful layer writes its updated
    statistics into ``stats`` (kge_tpu's ``Ctx.stats``) when a training
    step collects them (``KgeModel.collect_stats``); nothing else writes
    them.
    """

    #: the statistics collector of the running training step, or None
    stats: Optional[Dict[str, torch.Tensor]] = None

    def init_params(self, generator: torch.Generator) -> None:
        """Draw the scorer's own parameters (most scorers have none)."""

    def param_tree(self) -> Dict[str, Any]:
        """The scorer's parameters and statistics as kge_tpu's parameter
        tree of this scorer (nested dicts and lists with tensor leaves);
        empty for scorers without parameters."""
        return {}

    def forward(self, s_emb, p_emb, o_emb, combine: str) -> torch.Tensor:
        """``score_emb``: the call that ``torch.func.functional_call`` makes
        with stand-ins for the scorer's parameters."""
        return self.score_emb(s_emb, p_emb, o_emb, combine)

    def score_emb_spo(self, s_emb, p_emb, o_emb) -> torch.Tensor:
        return self.score_emb(s_emb, p_emb, o_emb, "spo").reshape(-1)

    def score_emb(self, s_emb, p_emb, o_emb, combine: str) -> torch.Tensor:
        n = p_emb.shape[0]
        if combine == "spo":
            out = self.score_emb_spo(s_emb, p_emb, o_emb)
        elif combine == "sp_":
            m = o_emb.shape[0]
            out = self.score_emb_spo(
                s_emb.repeat_interleave(m, 0), p_emb.repeat_interleave(m, 0),
                o_emb.repeat(n, 1),
            )
        elif combine == "_po":
            m = s_emb.shape[0]
            out = self.score_emb_spo(
                s_emb.repeat(n, 1), p_emb.repeat_interleave(m, 0),
                o_emb.repeat_interleave(m, 0),
            )
        elif combine == "s_o":
            n = s_emb.shape[0]
            m = p_emb.shape[0]
            out = self.score_emb_spo(
                s_emb.repeat_interleave(m, 0), p_emb.repeat(n, 1),
                o_emb.repeat_interleave(m, 0),
            )
        else:
            raise ValueError(f'cannot handle combine="{combine}"')
        return out.reshape(n, -1)

    def penalty(self, **kwargs):
        """Penalty terms of the scorer's own parameters."""
        return []

    def factorize_slot(self, s_emb, p_emb, o_emb, slot: int):
        """Optional (query, target_map[, score_map]) factorization of slot
        scoring: the score of candidates c of ``slot`` is
        ``score_map(query . target_map(c_emb))`` with the per-row query
        [n, d'] built from the two kept slots (the corrupted slot's entry is
        None). None when the scorer does not factorize."""
        return None

    def pooled_kernel_queries(self, s_emb, p_emb, o_emb, slot: int):
        """Optional (kind, queries) for the pooled distance kernel
        (ops/dist_pool.py): distance scorers whose per-candidate score is a
        plain elementwise distance ``-||q - c||`` return the kind ("l1" or
        "cmod") and the per-row query tensor(s) built from the two kept
        slots (the corrupted slot's entry is None). None (default): no
        kernel form for this scorer, slot or norm."""
        return None

    def pooled_kernel_kind(self, slot: int):
        """The kind ("l1" or "cmod") that ``pooled_kernel_queries`` gives
        for ``slot``, or None."""
        return None

    def score_emb_neg(self, s_emb, p_emb, o_emb, slot: int) -> torch.Tensor:
        """Score each row against its own k candidates in the corrupted
        ``slot`` (0=s, 1=p, 2=o): that slot's embeddings are [n, k, d*], the
        other two are [n, d*]; result [n, k]. The generic form broadcasts
        the row embeddings over k and delegates to "spo"."""
        emb3 = (s_emb, p_emb, o_emb)[slot]
        n, k = emb3.shape[0], emb3.shape[1]
        flat = [
            e.reshape(n * k, -1) if i == slot
            else e[:, None, :].expand(n, k, e.shape[-1]).reshape(n * k, -1)
            for i, e in enumerate((s_emb, p_emb, o_emb))
        ]
        return self.score_emb_spo(flat[0], flat[1], flat[2]).reshape(n, k)


# -- embedders -----------------------------------------------------------------


class KgeEmbedder(KgeBase):
    """Embeds a fixed vocabulary of objects (entities or relations)
    (reference KgeEmbedder, kge_model.py:216-351). Under kge_tpu's dtype
    policy a lookup table lives in ``param_dtype`` and its embeddings are
    cast to ``compute_dtype`` before dropout and scoring; other parameters
    (a projection, the Tucker3 core, the neural scorers') stay float32, as
    in kge_tpu."""

    def __init__(
        self,
        config: Config,
        dataset: Dataset,
        configuration_key: str,
        vocab_size: int,
        init_for_load_only=False,
        device=None,
    ):
        super().__init__(config, dataset, configuration_key)
        self.vocab_size = vocab_size
        embedder_type = self.get_option("type")
        if not config.exists(f"{embedder_type}.class_name"):
            config._import(embedder_type)
        self.embedder_type = embedder_type
        self.param_dtype = torch_dtype(config, "parallel.param_dtype")
        self.compute_dtype = torch_dtype(config, "parallel.compute_dtype")

    @staticmethod
    def create(
        config: Config,
        dataset: Dataset,
        configuration_key: str,
        vocab_size: int,
        init_for_load_only=False,
        device=None,
    ) -> "KgeEmbedder":
        """Factory: resolve ``<configuration_key>.type`` to a class and build it."""
        embedder_type = config.get_default(configuration_key + ".type")
        if not config.exists(f"{embedder_type}.class_name"):
            config._import(embedder_type)
        class_name = config.get(embedder_type + ".class_name")
        return misc.init_from(
            class_name,
            config.get("modules"),
            config=config,
            dataset=dataset,
            configuration_key=configuration_key,
            vocab_size=vocab_size,
            init_for_load_only=init_for_load_only,
            device=device,
        )

    @property
    def dim(self) -> int:
        raise NotImplementedError

    def init_params(self, generator: torch.Generator) -> None:
        raise NotImplementedError

    def embed(self, indexes: torch.Tensor, table=None,
              whole: bool = False) -> torch.Tensor:
        """Embeddings of the given vocabulary indexes, [n, dim]; ``table``
        stands in for the embedder's own table when given. ``whole``: the
        indexes serve every row of the batch (``KgeBase._dropout``)."""
        raise NotImplementedError

    def penalty(self, **kwargs):
        """Penalty terms as (name, value) pairs."""
        return []

    def embed_all(self) -> torch.Tensor:
        """Embeddings of all vocabulary members, [vocab_size, dim]."""
        raise NotImplementedError

    @property
    def vocab_shard(self):
        """(lo, hi, mesh) where ``embed_all`` gives the rows ``[lo, hi)`` of
        a row shard over the mesh's model axis, None where it gives all."""
        return None

    def postprocess_params(self) -> None:
        """Post-batch parameter transform (e.g. L_p renormalization)."""

    def param_tree(self) -> Dict[str, Any]:
        """The embedder's parameters as kge_tpu's parameter tree of this
        embedder: nested dicts with tensor leaves."""
        raise NotImplementedError

    @torch.no_grad()
    def init_pretrained(self, pretrained: "KgeEmbedder", self_ids,
                        pretrained_ids, ensure_all: bool = False) -> None:
        """Overwrite the rows whose external ids appear in ``pretrained``
        (kge_tpu ``KgeEmbedder.init_pretrained``): rows are matched with
        ``np.intersect1d``, read through the pretrained embedder's ``embed``
        in eval mode (its compute dtype) and written into this table in its
        dtype. Only a table named ``embeddings`` takes them, as in
        kge_tpu."""
        common, self_ind, pre_ind = np.intersect1d(
            np.array(self_ids), np.array(pretrained_ids), return_indices=True
        )
        if ensure_all and len(common) != len(self_ids):
            raise ValueError(
                "pretrained embedder does not cover all ids "
                f"({len(common)} of {len(self_ids)})"
            )
        table = self.param_tree()["embeddings"]
        training = pretrained.training
        pretrained.eval()
        try:
            rows = pretrained.embed(torch.as_tensor(pre_ind, device=table.device))
        finally:
            pretrained.train(training)
        ids = torch.as_tensor(self_ind, device=table.device)
        # a row shard (LookupEmbedder.row_range) takes its own rows
        lo, hi = getattr(self, "row_range", None) or (0, table.shape[0])
        keep = (ids >= lo) & (ids < hi)
        table[ids[keep] - lo] = rows[keep].to(table.dtype)


#: the rows of an entity or relation table drawn at a time at initialization
#: (``LookupEmbedder.init_params``): 65,536 rows of d = 128 are 32 MiB
INIT_BLOCK_ROWS = 65536


class LookupEmbedder(KgeEmbedder):
    """Dense embedding table with normalization (reference
    kge/model/embedder/lookup_embedder.py): one parameter ``embeddings``
    [vocab, dim], with dropout, normalization and lp/n3 penalty. Lookups go
    through ``embedding_gather`` (ops/embedding_ops.py), whose backward is
    the scatter kernel when a job selects it. Dropout acts in train mode."""

    def __init__(self, config, dataset, configuration_key, vocab_size,
                 init_for_load_only=False, device=None):
        super().__init__(
            config, dataset, configuration_key, vocab_size, init_for_load_only
        )
        self.normalize_p = float(self.get_option("normalize.p"))
        self.space = self.check_option("space", ["euclidean", "complex"])
        if self.space == "complex":
            self.regularize = self.check_option("regularize", ["", "lp", "n3"])
        else:
            self.regularize = self.check_option("regularize", ["", "lp"])
        self._dim = int(self.get_option("dim"))
        round_to = self.get_option("round_dim_to")
        if len(round_to) > 0:
            self._dim = misc.round_to_points(round_to, self._dim)
        dropout = float(self.get_option("dropout"))
        if dropout < 0:
            if config.get("job.auto_correct"):
                config.log(
                    f"Setting {configuration_key}.dropout to 0., was {dropout}"
                )
                dropout = 0.0
        self.dropout = dropout
        from kge_tpu_torch.parallel.mesh import DeviceCtx, entity_shard

        #: under a model axis above 1 (parallel/mesh.py), the entity rows
        #: [lo, hi) this rank holds, and its mesh; None, None otherwise
        self.row_range, self._mesh = None, None
        rows = vocab_size
        if DeviceCtx.param_spec(f"{configuration_key}/embeddings") == "model":
            shard = entity_shard(config, vocab_size)
            if shard is not None:
                lo, hi, self._mesh = shard
                self.row_range, rows = (lo, hi), hi - lo
        self.embeddings = nn.Parameter(
            torch.empty(rows, self._dim, dtype=self.param_dtype,
                        device=device)
        )

    @property
    def dim(self) -> int:
        return self._dim

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        """Draw the table in float32, normalize it, then store it in
        ``param_dtype`` (kge_tpu's order), in blocks of ``INIT_BLOCK_ROWS``
        rows drawn one after the other into one scratch buffer, each
        initializer scaled by the whole table's shape. A row shard draws
        every block, as one process does, and keeps its rows: its start
        equals the single one in every bit, and no rank holds the whole
        table."""
        init = self.initializer()
        lo, hi = self.row_range or (0, self.vocab_size)
        shape = (self.vocab_size, self._dim)
        scratch = torch.empty(min(INIT_BLOCK_ROWS, self.vocab_size), self._dim,
                              dtype=torch.float32, device=self.embeddings.device)
        for start in range(0, self.vocab_size, INIT_BLOCK_ROWS):
            stop = min(start + INIT_BLOCK_ROWS, self.vocab_size)
            block = scratch[:stop - start]
            init(block, generator, shape)
            first, last = max(start, lo), min(stop, hi)
            if first >= last:
                continue
            rows = block[first - start:last - start]
            if self.normalize_p > 0:
                rows = self._normalize(rows)
            self.embeddings[first - lo:last - lo] = rows

    def _normalize(self, table: torch.Tensor) -> torch.Tensor:
        """Rows scaled to unit L_p norm, in the table's dtype."""
        norm = torch.linalg.vector_norm(
            table, ord=self.normalize_p, dim=-1, keepdim=True
        )
        return table / norm.clamp_min(weak(1e-12, norm))

    @torch.no_grad()
    def postprocess_params(self) -> None:
        if self.normalize_p > 0:
            self.embeddings.copy_(self._normalize(self.embeddings))

    def param_tree(self) -> Dict[str, Any]:
        return {"embeddings": self.embeddings}

    def embed(self, indexes, table=None, whole=False) -> torch.Tensor:
        from kge_tpu_torch.ops.embedding_ops import embedding_gather

        if table is None:
            rows = self.lookup(indexes)
        else:
            rows = embedding_gather(
                table, torch.as_tensor(indexes, device=table.device))
        return self._dropout(rows.to(self.compute_dtype), whole=whole)

    def lookup(self, indexes) -> torch.Tensor:
        """The table's rows at ``indexes`` (no dropout, the table's dtype).
        On a row shard: the rows this rank holds, -0.0 elsewhere, summed
        over the model group (``ModelSum``); every row has one term that is
        not -0.0, the neutral element of the sum, so the rows are exact. The
        backward of the local gather is the scatter kernel on local ids, as
        on one card."""
        from kge_tpu_torch.ops.embedding_ops import embedding_gather

        table = self.embeddings
        indexes = torch.as_tensor(indexes, device=table.device)
        if self.row_range is None:
            return embedding_gather(table, indexes)
        lo, hi = self.row_range
        local = indexes.long() - lo
        own = (local >= 0) & (local < hi - lo)
        rows = embedding_gather(table, torch.where(own, local, 0))
        rows = torch.where(own.unsqueeze(-1), rows,
                           torch.full((), -0.0, dtype=rows.dtype,
                                      device=rows.device))
        return ModelSum.apply(rows, self._mesh)

    def embed_all(self) -> torch.Tensor:
        """All rows' embeddings; on a row shard the rows this rank holds
        (``row_range``), with their rows of the dropout mask drawn for the
        whole vocabulary."""
        vocab = None
        if self.row_range is not None:
            vocab = (self.row_range[0], self.vocab_size)
        return self._dropout(self.embeddings.to(self.compute_dtype), whole=True,
                             vocab=vocab)

    @property
    def vocab_shard(self):
        if self.row_range is None:
            return None
        return self.row_range[0], self.row_range[1], self._mesh

    def _abs_complex(self, parameters: torch.Tensor) -> torch.Tensor:
        re, im = torch.chunk(parameters, 2, dim=1)
        # epsilon inside the sqrt keeps the gradient finite at exactly 0
        return torch.sqrt(re ** 2 + im ** 2 + weak(1e-14, re))

    def penalty(self, indexes=None, indexes_weight=None, num_index_rows=None,
                **kwargs):
        """lp / n3 penalty, optionally weighted by batch index frequency
        (kge_tpu LookupEmbedder.penalty; reference lookup_embedder.py:149-173).

        The weighted form sums ``emb[idx]**p`` over all (possibly repeated)
        indexes, which equals the reference's sum over unique indexes times
        their counts. ``indexes_weight`` (matching indexes' leading shape)
        zeroes padded rows; ``num_index_rows`` overrides the denominator
        (the true number of index rows when the batch is padded).
        """
        result = []
        weight = float(self.get_option("regularize_weight"))
        if self.regularize == "" or weight == 0.0:
            return result
        if self.regularize == "n3":
            p = 3
        else:
            p = self.get_option("regularize_args.p") if self.has_option(
                "regularize_args.p"
            ) else 2
        p = float(p)
        name = f"{self.configuration_key}.L{int(p) if p == int(p) else p}_penalty"
        table = self.embeddings
        if not self.get_option("regularize_args.weighted"):
            parameters = table
            if self.regularize == "n3" and self.space == "complex":
                parameters = self._abs_complex(parameters)
                total = torch.sum(parameters ** p)
            else:
                total = torch.sum(torch.abs(parameters) ** p)
            if self.row_range is not None:
                # the shards' partial sums; each rank's rows keep their own
                # gradient
                total = ModelSum.apply(total, self._mesh)
            result.append((name, weak(weight / p, total) * total))
        else:
            if indexes is None:
                raise ValueError("weighted regularization requires batch indexes")
            idx = torch.as_tensor(indexes, device=table.device)
            if num_index_rows is None:
                num_index_rows = idx.shape[0]
            parameters = self.lookup(idx.reshape(-1))
            if self.regularize == "n3" and self.space == "complex":
                parameters = self._abs_complex(parameters)
            elif p % 2 == 1 and self.regularize != "n3":
                parameters = torch.abs(parameters)
            contrib = torch.sum(parameters ** p, dim=-1)  # [len(flat)]
            if indexes_weight is not None:
                w = torch.as_tensor(indexes_weight, device=table.device)
                w = w.reshape(idx.shape[0], -1)[:, :1].expand(
                    idx.shape[0], idx.numel() // max(idx.shape[0], 1)
                ).reshape(-1)
                contrib = contrib * w
            total = torch.sum(contrib)
            value = weak(weight / p, total) * total
            if isinstance(num_index_rows, torch.Tensor):
                value = value / num_index_rows
            else:
                value = value / weak(num_index_rows, value)
            result.append((name, value))
        return result


class ProjectionEmbedder(KgeEmbedder):
    """Base embedder followed by a bias-free linear projection (reference
    kge/model/embedder/projection_embedder.py; kge_tpu ProjectionEmbedder):
    the base embedder's module ``base_embedder`` and the parameter
    ``projection`` [dim_out, dim_in], kge_tpu's tree ``{"base": <base
    tree>, "projection": ...}``. Lookups go through the base embedder (its
    ``embedding_gather``); dropout acts on the projected embeddings in train
    mode; the lp penalty of the projection adds to the base's penalties.
    ``table`` (the row-sparse step's substitute) stands in for the base
    embedder's table."""

    def __init__(self, config, dataset, configuration_key, vocab_size,
                 init_for_load_only=False, device=None):
        super().__init__(
            config, dataset, configuration_key, vocab_size, init_for_load_only
        )
        self.base_embedder = KgeEmbedder.create(
            config, dataset, configuration_key + ".base_embedder", vocab_size,
            init_for_load_only, device=device,
        )
        self._dim = int(self.get_option("dim"))
        if self._dim < 0:
            self._dim = self.base_embedder.dim
            self.set_option("dim", self._dim, log=True)
        self.regularize = self.check_option("regularize", ["", "lp"])
        self.dropout = float(self.get_option("dropout"))
        self.projection = nn.Parameter(
            torch.empty(self._dim, self.base_embedder.dim, dtype=torch.float32,
                        device=device)
        )

    @property
    def dim(self) -> int:
        return self._dim

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.base_embedder.init_params(generator)
        self.initializer()(self.projection, generator)

    def param_tree(self) -> Dict[str, Any]:
        return {"base": self.base_embedder.param_tree(),
                "projection": self.projection}

    def _project(self, emb: torch.Tensor, whole: bool, vocab=None,
                 projection=None) -> torch.Tensor:
        # a compute-dtype embedding meets the float32 projection in float32
        emb, projection = promote(
            emb, self.projection if projection is None else projection)
        return self._dropout(emb @ projection.T, whole=whole, vocab=vocab)

    def embed(self, indexes, table=None, whole=False) -> torch.Tensor:
        return self._project(self.base_embedder.embed(indexes, table, whole),
                             whole)

    def embed_all(self) -> torch.Tensor:
        shard = self.vocab_shard
        if shard is None:
            return self._project(self.base_embedder.embed_all(), True)
        # the rank's rows meet the projection that every rank holds alike:
        # its gradient from them is the share of the rank's columns
        # (``ModelCopy``)
        return self._project(self.base_embedder.embed_all(), True,
                             (shard[0], self.vocab_size),
                             ModelCopy.apply(self.projection, shard[2]))

    @property
    def vocab_shard(self):
        return self.base_embedder.vocab_shard

    def postprocess_params(self) -> None:
        self.base_embedder.postprocess_params()

    def penalty(self, indexes=None, **kwargs):
        result = self.base_embedder.penalty(indexes=indexes, **kwargs)
        weight = float(self.get_option("regularize_weight"))
        if self.regularize == "" or weight == 0.0:
            return result
        p = float(self.get_option("regularize_args.p"))
        result.append(
            (
                f"{self.configuration_key}.L{int(p) if p == int(p) else p}_penalty",
                weight * torch.sum(torch.abs(self.projection) ** p),
            )
        )
        return result


class Tucker3RelationEmbedder(ProjectionEmbedder):
    """ProjectionEmbedder with dim fixed to entity_dim^2 (the Tucker core;
    reference kge/model/embedder/tucker3_relation_embedder.py)."""

    def __init__(self, config, dataset, configuration_key, vocab_size,
                 init_for_load_only=False, device=None):
        # dim is set by the model (RelationalTucker3) before creation; when
        # unset, derive it from the sibling entity embedder
        dim = config.get_default(configuration_key + ".dim")
        if dim < 0:
            ent_key = configuration_key.replace("relation_embedder", "entity_embedder")
            ent_dim = config.get_default(ent_key + ".dim")
            config.set(configuration_key + ".dim", ent_dim ** 2, create=True)
        super().__init__(
            config, dataset, configuration_key, vocab_size, init_for_load_only,
            device=device,
        )


# -- model ---------------------------------------------------------------------


class KgeModel(KgeBase):
    """A KGE model: entity/relation embedders + relational scorer.

    Subjects and objects share one entity embedder (as in the reference,
    kge_model.py:651-655).
    """

    def __init__(
        self,
        config: Config,
        dataset: Dataset,
        scorer: Union[RelationalScorer, type],
        create_embedders: bool = True,
        configuration_key=None,
        init_for_load_only=False,
        device=None,
    ):
        super().__init__(config, dataset, configuration_key)
        self._entity_embedder: Optional[KgeEmbedder] = None
        self._relation_embedder: Optional[KgeEmbedder] = None
        if create_embedders:
            self._entity_embedder = KgeEmbedder.create(
                config, dataset, self.configuration_key + ".entity_embedder",
                dataset.num_entities(), init_for_load_only=init_for_load_only,
                device=device,
            )
            self._relation_embedder = KgeEmbedder.create(
                config, dataset, self.configuration_key + ".relation_embedder",
                dataset.num_relations(), init_for_load_only=init_for_load_only,
                device=device,
            )
        if type(scorer) == type:
            self._scorer: RelationalScorer = scorer(
                config=config, dataset=dataset,
                configuration_key=self.configuration_key,
            )
        else:
            self._scorer = scorer

    def _init_configuration(self, config: Config, configuration_key):
        """Also resolve the model name; an unset configuration_key becomes the
        model name (reference kge_model.py:461-470), so subclasses may call
        this before ``super().__init__`` to read their options."""
        Configurable._init_configuration(self, config, configuration_key)
        if not getattr(self, "model", None):
            if self.configuration_key:
                self.model: str = config.get(self.configuration_key + ".type")
            else:
                self.model = config.get("model")
                self.configuration_key = self.model

    # -- factories ------------------------------------------------------------

    @staticmethod
    def create(
        config: Config,
        dataset: Dataset,
        configuration_key: Optional[str] = None,
        init_for_load_only=False,
        device=None,
    ) -> "KgeModel":
        """Factory: resolve the configured model name to a class and build it
        on ``device`` (default: ``job.device``)."""
        if device is None:
            from kge_tpu_torch.utils.seed import device_of

            device = device_of(config)
        if configuration_key is not None:
            model_name = config.get(configuration_key + ".type")
        else:
            model_name = config.get("model")
        config._import(model_name)
        class_name = config.get(model_name + ".class_name")
        return misc.init_from(
            class_name,
            config.get("modules"),
            config=config,
            dataset=dataset,
            configuration_key=configuration_key,
            init_for_load_only=init_for_load_only,
            device=device,
        )

    @staticmethod
    def create_from(
        checkpoint: Dict,
        dataset: Optional[Dataset] = None,
        use_tmp_log_folder: bool = True,
        new_config: Config = None,
        device=None,
    ) -> "KgeModel":
        """Load a model and its weights from a checkpoint written by kge_tpu
        or by this package."""
        from kge_tpu_torch.models.convert import load_jax_params

        config = Config.create_from(checkpoint)
        if new_config:
            config.load_config(new_config)
        if use_tmp_log_folder:
            config.log_folder = tempfile.mkdtemp(prefix="kge-")
        dataset = Dataset.create_from(checkpoint, config, dataset, preload_data=False)
        model = KgeModel.create(config, dataset, init_for_load_only=True,
                                device=device)
        load_jax_params(model, checkpoint["model"][0])
        model.meta = checkpoint["model"][1] if len(checkpoint["model"]) > 1 else {}
        return model

    # -- parameters -----------------------------------------------------------

    def init_params(self, generator: torch.Generator) -> None:
        """Initialize the embedders, then the scorer's own parameters, from
        ``generator``; then copy in pretrained rows where configured."""
        self._entity_embedder.init_params(generator)
        self._relation_embedder.init_params(generator)
        self._scorer.init_params(generator)
        self._apply_pretrained()

    def _apply_pretrained(self) -> None:
        """Initialize embeddings from a trained model when configured
        (``<embedder>.pretrain.model_filename``; kge_tpu
        ``KgeModel._apply_pretrained``, reference kge_model.py:399-450):
        the checkpoint is read with ``load_checkpoint`` (kge_tpu's or this
        package's), its model built on this model's device, and the rows
        matched by external id (``KgeEmbedder.init_pretrained``)."""

        def option(which: str, key: str):
            try:
                return self.get_option(f"{which}.pretrain.{key}")
            except KeyError:
                return "" if key == "model_filename" else False

        cache: Dict[str, "KgeModel"] = {}

        def load(filename: str) -> "KgeModel":
            if filename not in cache:
                from kge_tpu_torch.utils.io import load_checkpoint

                self.config.log(f"Initializing embeddings from {filename}")
                cache[filename] = KgeModel.create_from(
                    load_checkpoint(filename), device=self.device
                )
            return cache[filename]

        for which, embedder_of, ids in (
            ("entity_embedder", KgeModel.get_s_embedder, "entity_ids"),
            ("relation_embedder", KgeModel.get_p_embedder, "relation_ids"),
        ):
            filename = option(which, "model_filename")
            if filename:
                source = load(filename)
                embedder_of(self).init_pretrained(
                    embedder_of(source), getattr(self.dataset, ids)(),
                    getattr(source.dataset, ids)(),
                    ensure_all=option(which, "ensure_all"),
                )

    def postprocess_params(self) -> None:
        self._entity_embedder.postprocess_params()
        self._relation_embedder.postprocess_params()

    @property
    def device(self) -> torch.device:
        return next(self.parameters()).device

    #: Whether scoring functions index tables only with the ids they are
    #: passed (no internal id arithmetic). When True, a training job may
    #: rewrite a batch to "localized" ids over a gathered mini-table. The
    #: reciprocal wrapper computes p + |R| internally and opts out.
    supports_localized_batches: bool = True

    def num_parameters(self) -> int:
        """The size of kge_tpu's parameter tree, statistics included."""
        from kge_tpu_torch.models.convert import leaf_row_ranges, param_leaves

        shards = leaf_row_ranges(self)
        total = 0
        for path, t in param_leaves(self):
            if path in shards:  # a row shard counts the whole table
                lo, hi, rows = shards[path]
                total += int(t.numel()) // (hi - lo) * rows
            else:
                total += int(t.numel())
        return total

    @contextlib.contextmanager
    def collect_stats(self):
        """Collect, while the block runs, the statistics that the scorer's
        stateful layers compute in train mode (kge_tpu's ``Ctx.stats``):
        yields a dict of name -> tensor in which the last scoring call's
        values win. The training step writes them into the scorer after
        the optimizer update (``merge_stats``)."""
        scorer = self.get_scorer()
        stats: Dict[str, torch.Tensor] = {}
        scorer.stats = stats
        try:
            yield stats
        finally:
            scorer.stats = None

    @torch.no_grad()
    def merge_stats(self, stats: Dict[str, torch.Tensor]) -> None:
        """Write collected statistics into the scorer's buffers of the same
        names (kge_tpu/job/train.py:355-360)."""
        scorer = self.get_scorer()
        for name, value in stats.items():
            getattr(scorer, name).copy_(value)

    # -- penalty ---------------------------------------------------------------

    def penalty(self, batch: Optional[Dict] = None, **kwargs):
        """Penalty terms of scorer + embedders as (name, value) pairs.

        Entity penalties are doubled when the embedder is shared and
        unweighted, or computed over the concatenated (s, o) index matrix
        when weighted (reference kge_model.py:603-649).
        """
        result = list(self._scorer.penalty(**kwargs))
        if batch is not None and "triples" in batch:
            triples = batch["triples"]
            mask = batch.get("mask")
            if mask is not None:
                num_rows = torch.sum(mask)
            else:
                num_rows = triples.shape[0]
            result += self.get_p_embedder().penalty(
                indexes=triples[:, P], indexes_weight=mask,
                num_index_rows=num_rows, **kwargs
            )
            weighted = self.get_s_embedder().get_option("regularize_args.weighted")
            if weighted:
                entity_indexes = torch.stack(
                    [triples[:, S], triples[:, O]], dim=1
                )
                result += self.get_s_embedder().penalty(
                    indexes=entity_indexes, indexes_weight=mask,
                    num_index_rows=num_rows, **kwargs
                )
            else:
                ent = self.get_s_embedder().penalty(indexes=None, **kwargs)
                result += [(name, 2 * value) for name, value in ent]
        else:
            result += self.get_p_embedder().penalty(**kwargs)
            ent = self.get_s_embedder().penalty(**kwargs)
            result += [(name, 2 * value) for name, value in ent]
        return result

    # -- embedder access -------------------------------------------------------

    def get_s_embedder(self) -> KgeEmbedder:
        return self._entity_embedder

    def get_o_embedder(self) -> KgeEmbedder:
        return self._entity_embedder

    def get_p_embedder(self) -> KgeEmbedder:
        return self._relation_embedder

    def get_scorer(self) -> RelationalScorer:
        return self._scorer

    # -- scoring API -----------------------------------------------------------

    # Every scoring function takes ``tables``: an optional (entity table,
    # relation table) pair used in place of the embedders' own tables (the
    # gathered mini-tables of the row-sparse training step).

    def _promoted(self, *embs):
        """The embeddings cast to the dtype that JAX computes their scores
        in: their common dtype, promoted with that of the scorer's own
        parameters (float32) where it has any. A bfloat16 embedding meets
        a float32 one (a projection's output) or a neural scorer's
        parameters in float32, as in kge_tpu; the upcast is exact."""
        param = next(self._scorer.parameters(), None)
        return promote(*embs, dtype=None if param is None else param.dtype)

    @staticmethod
    def _candidates(embedder, ids, table=None) -> torch.Tensor:
        """The embeddings of a candidate list that serves every row of the
        batch (``ids``), or of the whole vocabulary (None): lookups whose
        dropout masks are drawn whole on every rank (``whole``)."""
        if ids is None:
            return embedder.embed_all()
        return embedder.embed(ids, table, whole=True)

    def score_spo(self, s, p, o, direction=None, tables=None) -> torch.Tensor:
        """Scores of the n triples (s_i, p_i, o_i); returns [n]."""
        ent, rel = tables if tables is not None else (None, None)
        s_emb, p_emb, o_emb = self._promoted(
            self.get_s_embedder().embed(s, ent),
            self.get_p_embedder().embed(p, rel),
            self.get_o_embedder().embed(o, ent),
        )
        return self._scorer.score_emb(s_emb, p_emb, o_emb, "spo").reshape(-1)

    def score_spo_neg(self, triples, samples, slot: int,
                      tables=None) -> torch.Tensor:
        """Scores of each triple against its per-row candidate replacements
        of ``slot``: samples is [n, k] -> result [n, k]. The two kept slots
        are embedded once per row; only the candidates look up n*k table
        rows."""
        n, k = samples.shape
        ent, rel = tables if tables is not None else (None, None)
        embedders = (
            self.get_s_embedder(), self.get_p_embedder(), self.get_o_embedder()
        )
        slot_tables = (ent, rel, ent)
        embs = []
        for i in range(3):
            ids = samples.reshape(-1) if i == slot else triples[:, i]
            e = embedders[i].embed(ids, slot_tables[i])
            embs.append(e.reshape(n, k, -1) if i == slot else e)
        embs = self._promoted(*embs)
        return self._scorer.score_emb_neg(embs[0], embs[1], embs[2], slot)

    def score_spo_neg_pooled(self, triples, pool, sel, pool_factor: int,
                             slot: int, tables=None) -> torch.Tensor:
        """Pool-implementation scoring for scorers whose many-targets forms
        are pairwise reductions (distance models); returns [n, k] for sel
        [n, k]. The pool (k * pool_factor ids, row ``j * pool_factor + f``
        candidate f of negative slot j) is embedded once as a mini-table,
        and row i's candidate j is its row ``j * pool_factor + sel[i, j]``.

        Two routes, selected by ``negative_sampling.pooled_kernel``:

        - the kernel ``pooled_dist_scores`` (ops/dist_pool.py), which never
          materializes the [n, k, d] candidates: ``auto`` takes it for
          tensors on a CUDA card whenever the scorer gives a kernel form
          (``pooled_kernel_queries``), ``always`` takes it on any device
          (its plain version serves CPU tensors);
        - the select route: the candidates are materialized by a one-hot
          contraction over the pool's group axis
          (``einsum("njf,jfd->njd")``, exact in float32: every sum has one
          non-zero term) and scored by ``score_emb_neg``. ``never``, CPU
          tensors under ``auto``, and slots without a kernel form (RotatE's
          relation corruption) take it.
        """
        k = sel.shape[1]
        ent, rel = tables if tables is not None else (None, None)
        embedders = (
            self.get_s_embedder(), self.get_p_embedder(), self.get_o_embedder()
        )
        slot_tables = (ent, rel, ent)
        pool_emb = embedders[slot].embed(pool, slot_tables[slot], whole=True)
        kept = [
            None if i == slot
            else embedders[i].embed(triples[:, i], slot_tables[i])
            for i in range(3)
        ]
        pool_emb, *kept = self._promoted(pool_emb, *kept)
        mode = self.config.get_default("negative_sampling.pooled_kernel")
        if mode == "always" or (mode == "auto" and pool_emb.device.type == "cuda"):
            spec = self._scorer.pooled_kernel_queries(
                kept[0], kept[1], kept[2], slot
            )
            if spec is not None:
                from kge_tpu_torch.ops.dist_pool import pooled_dist_scores

                kind, queries = spec
                pools = (
                    (pool_emb,) if kind == "l1"
                    else torch.chunk(pool_emb, 2, dim=1)
                )
                return pooled_dist_scores(queries, pools, sel, pool_factor, kind)
        # [k, pool_factor, d] grouped pool; cand[i, j] = pool3[j, sel[i, j]]
        pool3 = pool_emb.reshape(k, pool_factor, -1)
        sel_oh = torch.nn.functional.one_hot(sel.long(), pool_factor).to(
            pool_emb.dtype
        )
        cand = torch.einsum("njf,jfd->njd", sel_oh, pool3)
        embs = [cand if i == slot else kept[i] for i in range(3)]
        return self._scorer.score_emb_neg(embs[0], embs[1], embs[2], slot)

    def score_sp(self, s, p, o=None, tables=None) -> torch.Tensor:
        """Scores of (s_i, p_i, *) against all (or the given) objects; [n, m].
        Against all objects on a row shard: this rank's columns."""
        if o is None and tables is None:
            ring = self._ring_score(s, p, 2)
            if ring is not None:
                return ring
        ent, rel = tables if tables is not None else (None, None)
        s_emb = self.get_s_embedder().embed(s, ent)
        p_emb = self.get_p_embedder().embed(p, rel)
        o_emb = self._candidates(self.get_o_embedder(), o, ent)
        s_emb, p_emb, o_emb = self._promoted(s_emb, p_emb, o_emb)
        if o is None:
            return self._score_columns(s_emb, p_emb, o_emb, "sp_")
        return self._scorer.score_emb(s_emb, p_emb, o_emb, "sp_")

    def score_po(self, p, o, s=None, tables=None) -> torch.Tensor:
        """Scores of (*, p_i, o_i) against all (or the given) subjects; [n, m].
        Against all subjects on a row shard: this rank's columns."""
        if s is None and tables is None:
            ring = self._ring_score(o, p, 0)
            if ring is not None:
                return ring
        ent, rel = tables if tables is not None else (None, None)
        s_emb = self._candidates(self.get_s_embedder(), s, ent)
        p_emb = self.get_p_embedder().embed(p, rel)
        o_emb = self.get_o_embedder().embed(o, ent)
        s_emb, p_emb, o_emb = self._promoted(s_emb, p_emb, o_emb)
        if s is None:
            return self._score_columns(s_emb, p_emb, o_emb, "_po")
        return self._scorer.score_emb(s_emb, p_emb, o_emb, "_po")

    @property
    def vocab_shard(self):
        """(lo, hi, mesh) of the entity columns that this rank's scores
        against the whole vocabulary hold under a model axis (the rows of
        its entity shard), None where they hold every column."""
        return self.get_o_embedder().vocab_shard

    def _score_columns(self, s_emb, p_emb, o_emb, combine: str):
        """``score_emb`` against the whole entity vocabulary: on a row shard
        the rank's own columns, the kept slots' embeddings and the scorer's
        parameters passing ``ModelCopy``, so that the gradient of what
        every rank of the model group holds alike is summed over the
        group's columns."""
        shard = self.vocab_shard
        if shard is None:
            return self._scorer.score_emb(s_emb, p_emb, o_emb, combine)
        mesh = shard[2]

        def copy(t):
            return ModelCopy.apply(t, mesh)

        if combine == "sp_":
            s_emb, p_emb = copy(s_emb), copy(p_emb)
        else:
            p_emb, o_emb = copy(p_emb), copy(o_emb)
        params = {name: copy(param)
                  for name, param in self._scorer.named_parameters()}
        return torch.func.functional_call(self._scorer, params,
                                          (s_emb, p_emb, o_emb, combine))

    def _ring_score(self, ent_ids, rel_ids, slot: int):
        """This rank's columns of the scores of ``slot`` (2: objects, 0:
        subjects) against the whole vocabulary through kge_tpu's ring
        schedule (parallel/ring.py), or None where kge_tpu's rule does not
        engage it (kge_tpu/models/base.py ``_ring_score``): no model axis,
        ``parallel.ring_scoring: never``, an entity embedder that is not a
        ``LookupEmbedder``, embedding dropout in train mode, a scorer with
        parameters, or a scorer that does not factorize the slot. (kge_tpu's
        last condition, an entity count that the model axis divides, holds
        on every row shard: parallel/mesh.py ``entity_shard`` refuses the
        others.)"""
        ent_embedder = self.get_s_embedder()
        rel_embedder = self.get_p_embedder()
        if type(ent_embedder) is not LookupEmbedder or ent_embedder.row_range is None:
            return None
        if self.config.check("parallel.ring_scoring", ["auto", "never"]) == "never":
            return None
        if ent_embedder.training and (
                ent_embedder.dropout > 0 or getattr(rel_embedder, "dropout", 0.0) > 0):
            # the ring bypasses embed(); keep its dropout draws
            return None
        if next(self._scorer.parameters(), None) is not None:
            return None
        table = ent_embedder.embeddings
        cdtype = ent_embedder.compute_dtype
        rel_emb = rel_embedder.embed(rel_ids)
        # the scorer's (static) factorization of the slot
        dummy_e = torch.zeros((1, table.shape[-1]), dtype=cdtype, device=table.device)
        dummy_r = torch.zeros((1, rel_emb.shape[-1]), dtype=rel_emb.dtype,
                              device=rel_emb.device)
        args = (dummy_e, dummy_r, None) if slot == 2 else (None, dummy_r, dummy_e)
        fac = self._scorer.factorize_slot(*args, slot)
        if fac is None:
            return None
        target_map = fac[1]
        score_map = fac[2] if len(fac) > 2 else None
        scorer = self._scorer

        def make_query(rows, rel):
            rows, rel = promote(rows.to(cdtype), rel)
            kept = (rows, rel, None) if slot == 2 else (None, rel, rows)
            return scorer.factorize_slot(*kept, slot)[0]

        def map_targets(tbl):
            t = tbl.to(cdtype)
            return target_map(t) if target_map is not None else t

        from kge_tpu_torch.parallel.ring import ring_all_scores

        out = ring_all_scores(
            ent_embedder._mesh, table, torch.as_tensor(ent_ids, device=table.device),
            rel_emb, make_query, map_targets, lo=ent_embedder.row_range[0],
        )
        return out if score_map is None else score_map(out)

    def score_so(self, s, o, p=None, tables=None) -> torch.Tensor:
        """Scores of (s_i, *, o_i) against all (or the given) relations; [n, m]."""
        ent, rel = tables if tables is not None else (None, None)
        s_emb = self.get_s_embedder().embed(s, ent)
        o_emb = self.get_o_embedder().embed(o, ent)
        p_emb = self._candidates(self.get_p_embedder(), p, rel)
        s_emb, p_emb, o_emb = self._promoted(s_emb, p_emb, o_emb)
        return self._scorer.score_emb(s_emb, p_emb, o_emb, "s_o")

    def score_sp_po(self, s, p, o, entity_subset=None) -> torch.Tensor:
        """[score_sp(s,p,E) | score_po(p,o,E)] concatenated; [n, 2m]
        (reference kge_model.py:749-789)."""
        s_emb = self.get_s_embedder().embed(s)
        p_emb = self.get_p_embedder().embed(p)
        o_emb = self.get_o_embedder().embed(o)
        all_entities = self._candidates(self.get_s_embedder(), entity_subset)
        s_emb, p_emb, o_emb, all_entities = self._promoted(
            s_emb, p_emb, o_emb, all_entities)
        sp_scores = self._scorer.score_emb(s_emb, p_emb, all_entities, "sp_")
        po_scores = self._scorer.score_emb(all_entities, p_emb, o_emb, "_po")
        return torch.cat([sp_scores, po_scores], dim=1)

    def factorized_queries(self, triples: torch.Tensor, slots):
        """{slot: (pos [n], query [n, d'], targets [V, d'], score_map)} for
        several corrupted slots, embedding each triple slot once: ``pos`` is
        the spo score of each triple and the score of row i against
        candidate j of ``slot`` is ``score_map(query_i . targets_j)``. None
        when the scorer does not factorize. This is the query building of
        kge_tpu's ``score_all_grouped_multi`` (base.py:1181-1249); the
        product itself is left to the caller (the rank kernel)."""
        embedders = (
            self.get_s_embedder(), self.get_p_embedder(), self.get_o_embedder()
        )
        embs = self._promoted(
            *[embedders[i].embed(triples[:, i]) for i in range(3)])
        pos = self._scorer.score_emb_spo(embs[0], embs[1], embs[2])
        out = {}
        for slot in slots:
            kept = [e if i != slot else None for i, e in enumerate(embs)]
            fac = self._scorer.factorize_slot(kept[0], kept[1], kept[2], slot)
            if fac is None:
                return None
            q, target_map = fac[0], fac[1]
            score_map = fac[2] if len(fac) > 2 else None
            (t,) = self._promoted(embedders[slot].embed_all())
            if target_map is not None:
                t = target_map(t)
            out[slot] = (pos, *promote(q, t), score_map)
        return out

    def score_all_grouped_multi(self, triples, slots, targets, tables=None):
        """{slot: (pos [n], scores [n, m])} for several corrupted slots,
        embedding each triple slot ONCE (kge_tpu ``score_all_grouped_multi``,
        base.py:1181-1249).

        ``targets`` maps each slot to an [m] id array (e.g. the shared
        negative-sample rows) or to None, the whole vocabulary (``embed_all``:
        m = V, kge_tpu's call without ``targets``); the scores are flat
        matrices against those candidates, not kge_tpu's grouped [n, G, 128]
        layout. s, p and o are embedded once and the positives and every
        slot's query derive from the shared tensors, so the backward pass
        holds one lookup gradient per triple slot plus one per target list
        (none for the whole vocabulary, whose gradient comes from the
        product).
        Embedding dropout is drawn once per slot (not once per scoring
        call): callers gate on dropout being off. None when the scorer does
        not factorize.
        """
        ent, rel = tables if tables is not None else (None, None)
        embedders = (
            self.get_s_embedder(), self.get_p_embedder(), self.get_o_embedder()
        )
        slot_tables = (ent, rel, ent)
        embs = self._promoted(*[
            embedders[i].embed(triples[:, i], slot_tables[i]) for i in range(3)
        ])
        pos = self._scorer.score_emb_spo(embs[0], embs[1], embs[2])
        out = {}
        for slot in slots:
            kept = [e if i != slot else None for i, e in enumerate(embs)]
            fac = self._scorer.factorize_slot(kept[0], kept[1], kept[2], slot)
            if fac is None:
                return None
            q, target_map = fac[0], fac[1]
            score_map = fac[2] if len(fac) > 2 else None
            t = self._candidates(embedders[slot], targets[slot],
                                 slot_tables[slot])
            (t,) = self._promoted(t)
            if target_map is not None:
                t = target_map(t)
            q, t = promote(q, t)
            shard = embedders[slot].vocab_shard if targets[slot] is None else None
            if shard is not None:
                # the rank's own columns of the whole vocabulary
                q = ModelCopy.apply(q, shard[2])
            dot = q @ t.T
            out[slot] = (pos, dot if score_map is None else score_map(dot))
        return out

    def prepare_job(self, job, **kwargs):
        super().prepare_job(job, **kwargs)
        self._entity_embedder.prepare_job(job, **kwargs)
        self._relation_embedder.prepare_job(job, **kwargs)
