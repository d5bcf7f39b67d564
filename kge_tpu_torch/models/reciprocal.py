"""Reciprocal relations meta-model.

Wraps a base model trained with 2*|R| relations: (s,p,?) queries use relation
p, (?,p,o) queries are answered as (o, p+|R|, ?) queries on the reciprocal
relation (reference kge/model/reciprocal_relations_model.py; kge_tpu
models/reciprocal.py).
"""

from __future__ import annotations

import torch

from kge_tpu_torch.models.base import KgeModel


class ReciprocalRelationsModel(KgeModel):
    def __init__(self, config, dataset, configuration_key=None,
                 init_for_load_only=False, device=None):
        self._init_configuration(config, configuration_key)

        # base model sees a dataset with twice the relations
        alt_dataset = dataset.shallow_copy()
        alt_dataset._num_relations = dataset.num_relations() * 2
        alt_dataset._meta = dataset._meta.copy()
        if "relation_ids" in dataset._meta:
            ids = list(dataset.relation_ids())
            alt_dataset._meta["relation_ids"] = ids + [
                rid + "_reciprocal" for rid in ids
            ]
        base_model = KgeModel.create(
            config=config,
            dataset=alt_dataset,
            configuration_key=self.configuration_key + ".base_model",
            init_for_load_only=init_for_load_only,
            device=device,
        )
        super().__init__(
            config=config,
            dataset=dataset,
            scorer=base_model.get_scorer(),
            create_embedders=False,
            init_for_load_only=init_for_load_only,
        )
        self._base_model = base_model
        self._entity_embedder = base_model.get_s_embedder()
        self._relation_embedder = base_model.get_p_embedder()

    #: p + |R| is computed inside the model, so batches cannot be rewritten
    #: to mini-table positions
    supports_localized_batches = False

    def init_params(self, generator):
        self._base_model.init_params(generator)

    def postprocess_params(self):
        self._base_model.postprocess_params()

    def prepare_job(self, job, **kwargs):
        self._base_model.prepare_job(job, **kwargs)

    def _reciprocal(self, triples: torch.Tensor) -> torch.Tensor:
        """(o, p + |R|, s) for every (s, p, o)."""
        return torch.stack(
            [triples[:, 2], triples[:, 1] + self.dataset.num_relations(),
             triples[:, 0]], dim=1,
        )

    def penalty(self, batch=None, **kwargs):
        """Base penalty; with weighted relation regularization, additionally
        penalize the reciprocal relation rows touched by the batch
        (reference reciprocal_relations_model.py:58-72)."""
        result = self._base_model.penalty(batch=batch, **kwargs)
        embedder = self.get_p_embedder()
        is_weighted = embedder.get_option("regularize_args.weighted")
        regularize = getattr(embedder, "regularize", "")
        regularize_weight = embedder.get_option("regularize_weight")
        if is_weighted and regularize != "" and regularize_weight != 0.0 \
                and batch is not None and "triples" in batch:
            reciprocal_indexes = (
                batch["triples"][:, 1] + self.dataset.num_relations()
            )
            mask = batch.get("mask")
            num_rows = torch.sum(mask) if mask is not None else None
            result += embedder.penalty(
                indexes=reciprocal_indexes, indexes_weight=mask,
                num_index_rows=num_rows, **kwargs
            )
        return result

    def score_spo(self, s, p, o, direction=None, tables=None):
        if tables is not None:
            raise ValueError(
                "The reciprocal relations model cannot score substituted tables."
            )
        if direction == "o":
            return self._base_model.score_spo(s, p, o, "o")
        elif direction == "s":
            return self._base_model.score_spo(
                o, p + self.dataset.num_relations(), s, "o"
            )
        raise ValueError(
            "The reciprocal relations model cannot compute undirected spo scores."
        )

    def score_spo_neg(self, triples, samples, slot, tables=None):
        if tables is not None:
            raise ValueError(
                "The reciprocal relations model cannot score substituted tables."
            )
        if slot == 2:  # corrupt o: base model direct
            return self._base_model.score_spo_neg(triples, samples, 2)
        if slot == 0:  # corrupt s: (sample, p, o) = base (o, p+|R|, sample)
            return self._base_model.score_spo_neg(
                self._reciprocal(triples), samples, 2
            )
        raise ValueError("The reciprocal relations model cannot score relations.")

    def factorized_queries(self, triples, slots):
        """Each slot maps to a direction-specific base query: o-corruption
        scores (s, p, ?) directly, s-corruption scores (o, p+|R|, ?); the
        per-slot positives differ accordingly (kge_tpu reciprocal.py:107-137)."""
        out = {}
        for slot in slots:
            if slot == 2:
                sub = self._base_model.factorized_queries(triples, [2])
            elif slot == 0:
                sub = self._base_model.factorized_queries(
                    self._reciprocal(triples), [2]
                )
            else:
                return None
            if sub is None:
                return None
            out[slot] = sub[2]
        return out

    def score_all_grouped_multi(self, triples, slots, targets, tables=None):
        """Each slot maps to a direction-specific base query: o-corruption
        scores (s, p, ?) directly, s-corruption scores (o, p+|R|, ?); the
        per-slot positives differ accordingly (kge_tpu reciprocal.py:107-137)."""
        if tables is not None:
            raise ValueError(
                "The reciprocal relations model cannot score substituted tables."
            )
        out = {}
        for slot in slots:
            if slot == 2:
                sub = self._base_model.score_all_grouped_multi(
                    triples, [2], {2: targets[slot]}
                )
            elif slot == 0:
                sub = self._base_model.score_all_grouped_multi(
                    self._reciprocal(triples), [2], {2: targets[slot]}
                )
            else:
                return None
            if sub is None:
                return None
            out[slot] = sub[2]
        return out

    def score_sp(self, s, p, o=None, tables=None):
        return self._base_model.score_sp(s, p, o, tables)

    def score_po(self, p, o, s=None, tables=None):
        return self._base_model.score_sp(
            o, p + self.dataset.num_relations(), s, tables
        )

    def score_so(self, s, o, p=None, tables=None):
        raise ValueError("The reciprocal relations model cannot score relations.")

    def score_sp_po(self, s, p, o, entity_subset=None):
        p_inv = p + self.dataset.num_relations()
        sp_scores = self._base_model.score_sp(s, p, entity_subset)
        po_scores = self._base_model.score_sp(o, p_inv, entity_subset)
        return torch.cat([sp_scores, po_scores], dim=1)
