"""Model core: embedders, scorers, and the KGE model API.

The port of kge_tpu/models/base.py in PyTorch's idiom: models, scorers and
embedders are ``nn.Module``s whose parameters are tensors on an explicit
device, and scoring functions read them from the module (kge_tpu passes a
parameter pytree to pure functions instead). The scoring API keeps the
reference's names and combine semantics (score_spo/score_sp/score_po/
score_sp_po with "spo"/"sp_"/"_po", kge_model.py:122-213,663-789).
Randomness comes from explicit ``torch.Generator``s.

Ported so far: what filtered entity-ranking evaluation and
negative-sampling training (shared, pooled and per-row negatives) need. Pretrained initialization, projection
embedders and the ring-sharded scoring path are not ported yet (see
ROADMAP.md).

Where kge_tpu swaps gathered mini-tables into the parameter tree for the
row-sparse training step, the embedders here own their tables, so ``embed``
and the scoring functions take the substitute explicitly (``table=`` /
``tables=``): a tensor used in place of the embedder's own table for that
call. No table-sized gradient exists on that step.
"""

from __future__ import annotations

import math
import tempfile
from typing import Any, Callable, Dict, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from kge_tpu_torch import misc
from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset

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
    ``fn(tensor, generator)``; the automatic ``a = -b`` rule for uniform_ is
    applied by the caller (``KgeBase.initializer``)."""
    args = dict(initialize_args or {})
    args.pop("+++", None)

    def uniform(t, g, a, b):
        return t.uniform_(a, b, generator=g)

    if initialize == "normal_":
        mean = float(args.get("mean", 0.0))
        std = float(args.get("std", 1.0))
        return lambda t, g: t.normal_(mean, std, generator=g)
    elif initialize == "uniform_":
        a = float(args.get("a", 0.0))
        b = float(args.get("b", 1.0))
        return lambda t, g: uniform(t, g, a, b)
    elif initialize == "xavier_uniform_":
        gain = float(args.get("gain", 1.0))

        def init(t, g):
            fan_in, fan_out = _fans(t.shape)
            bound = gain * math.sqrt(6.0 / (fan_in + fan_out))
            return uniform(t, g, -bound, bound)

        return init
    elif initialize == "xavier_normal_":
        gain = float(args.get("gain", 1.0))

        def init(t, g):
            fan_in, fan_out = _fans(t.shape)
            return t.normal_(0.0, gain * math.sqrt(2.0 / (fan_in + fan_out)),
                             generator=g)

        return init
    elif initialize == "kaiming_uniform_":
        a = float(args.get("a", 0.0))

        def init(t, g):
            fan_in, _ = _fans(t.shape)
            bound = math.sqrt(2.0 / (1 + a ** 2)) * math.sqrt(3.0 / fan_in)
            return uniform(t, g, -bound, bound)

        return init
    elif initialize == "constant_":
        val = float(args.get("val", 0.0))
        return lambda t, g: t.fill_(val)
    elif initialize == "ones_":
        return lambda t, g: t.fill_(1.0)
    elif initialize == "zeros_":
        return lambda t, g: t.zero_()
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
    """

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
    (reference KgeEmbedder, kge_model.py:216-351)."""

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

    def embed(self, indexes: torch.Tensor, table=None) -> torch.Tensor:
        """Embeddings of the given vocabulary indexes, [n, dim]; ``table``
        stands in for the embedder's own table when given."""
        raise NotImplementedError

    def penalty(self, **kwargs):
        """Penalty terms as (name, value) pairs."""
        return []

    def embed_all(self) -> torch.Tensor:
        """Embeddings of all vocabulary members, [vocab_size, dim]."""
        raise NotImplementedError

    def postprocess_params(self) -> None:
        """Post-batch parameter transform (e.g. L_p renormalization)."""


class LookupEmbedder(KgeEmbedder):
    """Dense embedding table with normalization (reference
    kge/model/embedder/lookup_embedder.py): one parameter ``embeddings``
    [vocab, dim], with dropout, normalization and lp/n3 penalty. Lookups go
    through ``embedding_gather`` (ops/embedding_ops.py), whose backward is
    the scatter kernel when a job selects it. Dropout acts in train mode
    and draws from ``dropout_generator`` (set by the training job)."""

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
        self.dropout_generator: Optional[torch.Generator] = None
        self.embeddings = nn.Parameter(
            torch.empty(vocab_size, self._dim, dtype=torch.float32,
                        device=device)
        )

    @property
    def dim(self) -> int:
        return self._dim

    @torch.no_grad()
    def init_params(self, generator: torch.Generator) -> None:
        self.initializer()(self.embeddings, generator)
        self.postprocess_params()

    def _normalize(self, table: torch.Tensor) -> torch.Tensor:
        norm = torch.linalg.vector_norm(
            table, ord=self.normalize_p, dim=-1, keepdim=True
        )
        return table / norm.clamp_min(1e-12)

    @torch.no_grad()
    def postprocess_params(self) -> None:
        if self.normalize_p > 0:
            self.embeddings.copy_(self._normalize(self.embeddings))

    def _dropout(self, emb: torch.Tensor) -> torch.Tensor:
        """Inverted dropout (torch.nn.Dropout semantics) in train mode."""
        if not self.training or self.dropout <= 0.0:
            return emb
        keep = 1.0 - self.dropout
        mask = torch.rand(
            emb.shape, generator=self.dropout_generator, device=emb.device
        ) < keep
        return torch.where(mask, emb / keep, torch.zeros_like(emb))

    def embed(self, indexes, table=None) -> torch.Tensor:
        from kge_tpu_torch.ops.embedding_ops import embedding_gather

        if table is None:
            table = self.embeddings
        indexes = torch.as_tensor(indexes, device=table.device)
        return self._dropout(embedding_gather(table, indexes))

    def embed_all(self) -> torch.Tensor:
        return self._dropout(self.embeddings)

    def _abs_complex(self, parameters: torch.Tensor) -> torch.Tensor:
        re, im = torch.chunk(parameters, 2, dim=1)
        # epsilon inside the sqrt keeps the gradient finite at exactly 0
        return torch.sqrt(re ** 2 + im ** 2 + 1e-14)

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
        from kge_tpu_torch.ops.embedding_ops import embedding_gather

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
                value = weight / p * torch.sum(parameters ** p)
            else:
                value = weight / p * torch.sum(torch.abs(parameters) ** p)
            result.append((name, value))
        else:
            if indexes is None:
                raise ValueError("weighted regularization requires batch indexes")
            idx = torch.as_tensor(indexes, device=table.device)
            if num_index_rows is None:
                num_index_rows = idx.shape[0]
            parameters = embedding_gather(table, idx.reshape(-1))
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
            value = weight / p * torch.sum(contrib) / num_index_rows
            result.append((name, value))
        return result


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
        """Initialize all embedders from ``generator``."""
        self._entity_embedder.init_params(generator)
        self._relation_embedder.init_params(generator)

    def postprocess_params(self) -> None:
        self._entity_embedder.postprocess_params()
        self._relation_embedder.postprocess_params()

    @property
    def device(self) -> torch.device:
        return self.get_s_embedder().embeddings.device

    #: Whether scoring functions index tables only with the ids they are
    #: passed (no internal id arithmetic). When True, a training job may
    #: rewrite a batch to "localized" ids over a gathered mini-table. The
    #: reciprocal wrapper computes p + |R| internally and opts out.
    supports_localized_batches: bool = True

    def num_parameters(self) -> int:
        return sum(int(p.numel()) for p in self.parameters())

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

    def score_spo(self, s, p, o, direction=None, tables=None) -> torch.Tensor:
        """Scores of the n triples (s_i, p_i, o_i); returns [n]."""
        ent, rel = tables if tables is not None else (None, None)
        s_emb = self.get_s_embedder().embed(s, ent)
        p_emb = self.get_p_embedder().embed(p, rel)
        o_emb = self.get_o_embedder().embed(o, ent)
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
        pool_emb = embedders[slot].embed(pool, slot_tables[slot])
        kept = [
            None if i == slot
            else embedders[i].embed(triples[:, i], slot_tables[i])
            for i in range(3)
        ]
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
        """Scores of (s_i, p_i, *) against all (or the given) objects; [n, m]."""
        ent, rel = tables if tables is not None else (None, None)
        s_emb = self.get_s_embedder().embed(s, ent)
        p_emb = self.get_p_embedder().embed(p, rel)
        o_emb = (self.get_o_embedder().embed_all() if o is None
                 else self.get_o_embedder().embed(o, ent))
        return self._scorer.score_emb(s_emb, p_emb, o_emb, "sp_")

    def score_po(self, p, o, s=None, tables=None) -> torch.Tensor:
        """Scores of (*, p_i, o_i) against all (or the given) subjects; [n, m]."""
        ent, rel = tables if tables is not None else (None, None)
        s_emb = (self.get_s_embedder().embed_all() if s is None
                 else self.get_s_embedder().embed(s, ent))
        p_emb = self.get_p_embedder().embed(p, rel)
        o_emb = self.get_o_embedder().embed(o, ent)
        return self._scorer.score_emb(s_emb, p_emb, o_emb, "_po")

    def score_so(self, s, o, p=None, tables=None) -> torch.Tensor:
        """Scores of (s_i, *, o_i) against all (or the given) relations; [n, m]."""
        ent, rel = tables if tables is not None else (None, None)
        s_emb = self.get_s_embedder().embed(s, ent)
        o_emb = self.get_o_embedder().embed(o, ent)
        p_emb = (self.get_p_embedder().embed_all() if p is None
                 else self.get_p_embedder().embed(p, rel))
        return self._scorer.score_emb(s_emb, p_emb, o_emb, "s_o")

    def score_sp_po(self, s, p, o, entity_subset=None) -> torch.Tensor:
        """[score_sp(s,p,E) | score_po(p,o,E)] concatenated; [n, 2m]
        (reference kge_model.py:749-789)."""
        s_emb = self.get_s_embedder().embed(s)
        p_emb = self.get_p_embedder().embed(p)
        o_emb = self.get_o_embedder().embed(o)
        if entity_subset is not None:
            all_entities = self.get_s_embedder().embed(entity_subset)
        else:
            all_entities = self.get_s_embedder().embed_all()
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
        embs = [embedders[i].embed(triples[:, i]) for i in range(3)]
        pos = self._scorer.score_emb_spo(embs[0], embs[1], embs[2])
        out = {}
        for slot in slots:
            kept = [e if i != slot else None for i, e in enumerate(embs)]
            fac = self._scorer.factorize_slot(kept[0], kept[1], kept[2], slot)
            if fac is None:
                return None
            q, target_map = fac[0], fac[1]
            score_map = fac[2] if len(fac) > 2 else None
            t = embedders[slot].embed_all()
            if target_map is not None:
                t = target_map(t)
            out[slot] = (pos, q, t, score_map)
        return out

    def score_all_grouped_multi(self, triples, slots, targets, tables=None):
        """{slot: (pos [n], scores [n, m])} for several corrupted slots,
        embedding each triple slot ONCE (kge_tpu ``score_all_grouped_multi``
        with ``targets``, base.py:1181-1236).

        ``targets`` maps each slot to an [m] id array (e.g. the shared
        negative-sample rows); the scores are flat matrices against those
        candidates. s, p and o are embedded once and the positives and every
        slot's query derive from the shared tensors, so the backward pass
        holds one lookup gradient per triple slot plus one per target list.
        Embedding dropout is drawn once per slot (not once per scoring
        call): callers gate on dropout being off. None when the scorer does
        not factorize.
        """
        ent, rel = tables if tables is not None else (None, None)
        embedders = (
            self.get_s_embedder(), self.get_p_embedder(), self.get_o_embedder()
        )
        slot_tables = (ent, rel, ent)
        embs = [
            embedders[i].embed(triples[:, i], slot_tables[i]) for i in range(3)
        ]
        pos = self._scorer.score_emb_spo(embs[0], embs[1], embs[2])
        out = {}
        for slot in slots:
            kept = [e if i != slot else None for i, e in enumerate(embs)]
            fac = self._scorer.factorize_slot(kept[0], kept[1], kept[2], slot)
            if fac is None:
                return None
            q, target_map = fac[0], fac[1]
            score_map = fac[2] if len(fac) > 2 else None
            t = embedders[slot].embed(targets[slot], slot_tables[slot])
            if target_map is not None:
                t = target_map(t)
            dot = q @ t.T
            out[slot] = (pos, dot if score_map is None else score_map(dot))
        return out

    def prepare_job(self, job, **kwargs):
        super().prepare_job(job, **kwargs)
        self._entity_embedder.prepare_job(job, **kwargs)
        self._relation_embedder.prepare_job(job, **kwargs)
