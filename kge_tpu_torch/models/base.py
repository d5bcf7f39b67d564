"""Model core: embedders, scorers, and the KGE model API.

The port of kge_tpu/models/base.py in PyTorch's idiom: models, scorers and
embedders are ``nn.Module``s whose parameters are tensors on an explicit
device, and scoring functions read them from the module (kge_tpu passes a
parameter pytree to pure functions instead). The scoring API keeps the
reference's names and combine semantics (score_spo/score_sp/score_po/
score_sp_po with "spo"/"sp_"/"_po", kge_model.py:122-213,663-789).
Randomness comes from explicit ``torch.Generator``s.

Ported so far: what filtered entity-ranking evaluation needs. Penalties,
pretrained initialization, projection embedders and the ring-sharded
scoring path are not ported yet (see ROADMAP.md).
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
        else:
            raise ValueError(f'cannot handle combine="{combine}"')
        return out.reshape(n, -1)

    def factorize_slot(self, s_emb, p_emb, o_emb, slot: int):
        """Optional (query, target_map[, score_map]) factorization of slot
        scoring: the score of candidates c of ``slot`` is
        ``score_map(query . target_map(c_emb))`` with the per-row query
        [n, d'] built from the two kept slots (the corrupted slot's entry is
        None). None when the scorer does not factorize."""
        return None


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

    def embed(self, indexes: torch.Tensor) -> torch.Tensor:
        """Embeddings of the given vocabulary indexes, [n, dim]."""
        raise NotImplementedError

    def embed_all(self) -> torch.Tensor:
        """Embeddings of all vocabulary members, [vocab_size, dim]."""
        raise NotImplementedError

    def postprocess_params(self) -> None:
        """Post-batch parameter transform (e.g. L_p renormalization)."""


class LookupEmbedder(KgeEmbedder):
    """Dense embedding table with normalization (reference
    kge/model/embedder/lookup_embedder.py): one parameter ``embeddings``
    [vocab, dim]. Its ``dropout`` acts only in training, which is not
    ported yet: it is read and checked as kge_tpu does."""

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

    def embed(self, indexes) -> torch.Tensor:
        indexes = torch.as_tensor(indexes, device=self.embeddings.device)
        return self.embeddings[indexes.long()]

    def embed_all(self) -> torch.Tensor:
        return self.embeddings


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

    def score_spo(self, s, p, o, direction=None) -> torch.Tensor:
        """Scores of the n triples (s_i, p_i, o_i); returns [n]."""
        s_emb = self.get_s_embedder().embed(s)
        p_emb = self.get_p_embedder().embed(p)
        o_emb = self.get_o_embedder().embed(o)
        return self._scorer.score_emb(s_emb, p_emb, o_emb, "spo").reshape(-1)

    def score_sp(self, s, p, o=None) -> torch.Tensor:
        """Scores of (s_i, p_i, *) against all (or the given) objects; [n, m]."""
        s_emb = self.get_s_embedder().embed(s)
        p_emb = self.get_p_embedder().embed(p)
        o_emb = (self.get_o_embedder().embed_all() if o is None
                 else self.get_o_embedder().embed(o))
        return self._scorer.score_emb(s_emb, p_emb, o_emb, "sp_")

    def score_po(self, p, o, s=None) -> torch.Tensor:
        """Scores of (*, p_i, o_i) against all (or the given) subjects; [n, m]."""
        s_emb = (self.get_s_embedder().embed_all() if s is None
                 else self.get_s_embedder().embed(s))
        p_emb = self.get_p_embedder().embed(p)
        o_emb = self.get_o_embedder().embed(o)
        return self._scorer.score_emb(s_emb, p_emb, o_emb, "_po")

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

    def prepare_job(self, job, **kwargs):
        super().prepare_job(job, **kwargs)
        self._entity_embedder.prepare_job(job, **kwargs)
        self._relation_embedder.prepare_job(job, **kwargs)
