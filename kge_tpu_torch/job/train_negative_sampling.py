"""Negative-sampling training (reference kge/job/train_negative_sampling.py;
kge_tpu/job/train_negative_sampling.py).

Per slot with num_samples > 0: scores = [positive score | negative scores],
labels = column 0, loss summed per slot and divided by batch size.

Implementations (``negative_sampling.implementation``), all of kge_tpu's:

- ``batch`` with ``shared: true`` (what ``auto`` resolves to when negatives
  are shared): one sample row for the whole batch, scored against the
  batch's unique targets;
- ``batch`` with per-row negatives: scored against the distinct ids the
  batch samples (a unique padded to kge_tpu's static size ``min(n * num,
  vocab)`` with id 0), then each row picks its columns;
- ``pool``: a pool of ``num * pool_factor`` candidates per batch, of which
  every row selects one per group of ``pool_factor``. Matmul scorers
  (ComplEx) score the pool once and select columns; distance scorers
  (TransE, RotatE) score each row's own candidates through
  ``score_spo_neg_pooled`` and its kernel (ops/dist_pool.py). A pool is
  drawn on the device only: with ``on_device: never`` the host draws
  per-row samples, which are scored as ``batch`` scores them (kge_tpu's
  route);
- ``all``: every row scored against the whole vocabulary, then each row
  picks its samples (``ops/pick.py`` ``picked_scores``);
- ``triple``: per-row negatives scored row by row (``score_spo_neg``).

Negatives are drawn on the device or by the host sampler (with filtering).
Every implementation but ``all`` runs on the dense step and on the
row-sparse step (``train.sparse_embedding_update``) with any optimizer
rule; ``negative_sampling.fused_scoring: always`` localizes each batch on
the dense step too, so that each table's gradient is written once.
kge_tpu's ``auto`` ladder and refusals are kept, so a configuration
resolves to the same implementation in both packages.

Under a data axis (parallel/mesh.py) every rank draws the whole batch's
negatives, from generators in lockstep, before it takes its rows
(``_complete_batch``): shared samples and pools are the same on every rank,
and per-row samples the rank's rows of the whole draw. The row-sparse step
localizes the whole batch on every rank, so that the mini-tables, gathered
from the entity table's shards, have one layout everywhere, takes the loss
of the rank's rows, sums the row gradients over the data group and updates
the rows the rank holds. Under a model axis every implementation runs:
lookups (candidate lists and pools among them) gather their rows from the
entity table's shards; ``all`` scores a rank's batch rows against the
entity rows it holds and picks each row's samples on the rank that holds
them (``ops/pick.py`` ``picked_scores_columns``); the fused step assembles
its entity mini-table from the shards (``LookupEmbedder.lookup``), whose
backward returns each shard's rows their gradient.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch

from kge_tpu_torch.job.job import Job
from kge_tpu_torch.job.train import TrainingJob, _detach
from kge_tpu_torch.ops.pick import picked_scores, picked_scores_columns
from kge_tpu_torch.ops.sampler import SLOT_STR, KgeSampler

S, P, O = 0, 1, 2


class TrainingJobNegativeSampling(TrainingJob):
    def __init__(self, config, dataset, parent_job=None, model=None,
                 forward_only=False):
        super().__init__(config, dataset, parent_job, model=model,
                         forward_only=forward_only)
        self._sampler = KgeSampler.create(config, "negative_sampling", dataset)
        self._sampler.seed(self._rng_seed ^ 0x7A11)

        if self.__class__ == TrainingJobNegativeSampling:
            for f in Job.job_created_hooks:
                f(self)

    @property
    def type_str(self):
        return "negative_sampling"

    def _prepare_data(self):
        """Resolve the "auto" implementation heuristic
        (reference train_negative_sampling.py:35-45)."""
        self.config.log(
            "Preparing negative sampling training job with "
            "'{}' scoring function ...".format(
                self.config.get("negative_sampling.implementation")
            )
        )
        implementation = self.config.get("negative_sampling.implementation")
        if implementation == "auto":
            # kge_tpu's ladder: shared negatives score against the batch's
            # unique targets ("batch"); otherwise auto prefers pool where
            # its requirements hold (no filtering, on-device sampling
            # allowed), then all under a score-matrix memory gate, then
            # triple.
            if self._sampler.shared:
                implementation = "batch"
            else:
                vocab = max(
                    (int(self._sampler.vocabulary_size[slot])
                     for slot in (S, O)
                     if self._sampler.num_samples[slot] > 0),
                    default=self.dataset.num_entities(),
                )
                # "all" reads the whole table each step, which rules out the
                # row-sparse/fused paths: don't auto-select it when the
                # config demands those.
                wants_rows_only = (
                    self.config.get("train.sparse_embedding_update") == "always"
                    or self.config.get("negative_sampling.fused_scoring")
                    == "always"
                )
                # a step holds one forward score matrix plus its backward
                # cotangent per active entity slot
                active_entity_slots = sum(
                    1 for slot in (S, O) if self._sampler.num_samples[slot] > 0
                ) or 1
                score_matrix_bytes = (
                    4 * self.batch_size * vocab * active_entity_slots * 2
                )
                pool_ok = (
                    not self._sampler.filter_positives.any()
                    and self.config.get("negative_sampling.on_device")
                    != "never"
                    and not self.config.get("negative_sampling.auto_exact")
                )
                if pool_ok:
                    implementation = "pool"
                elif score_matrix_bytes <= (1 << 31) and not wants_rows_only:
                    implementation = "all"
                else:
                    implementation = "triple"
            self.config.set(
                "negative_sampling.implementation", implementation, log=True
            )
        self._implementation = self.config.check(
            "negative_sampling.implementation",
            ["triple", "batch", "all", "pool"],
        )
        self._pool_factor = int(self.config.get("negative_sampling.pool_factor"))
        if self._implementation == "pool":
            if self._sampler.shared:
                raise ValueError(
                    "negative_sampling.implementation=pool replaces per-row "
                    "sampling; it cannot be combined with shared negatives"
                )
            if self._sampler.filter_positives.any():
                raise ValueError(
                    "negative_sampling.implementation=pool draws candidates "
                    "on-device and cannot filter positives; use "
                    "implementation triple/all with filtering"
                )
            if self._pool_factor < 1:
                raise ValueError("negative_sampling.pool_factor must be >= 1")
        self.triples = self.dataset.split(self.train_split)
        self.num_examples = len(self.triples)
        self._active_slots = [
            slot for slot in (S, P, O) if self._sampler.num_samples[slot] > 0
        ]

        fused = self.config.check(
            "negative_sampling.fused_scoring", ["auto", "always", "never"]
        )
        self._fused = fused == "always" and self._fused_eligible()
        if fused == "always" and not self._fused:
            raise ValueError(
                "negative_sampling.fused_scoring=always requires lookup "
                "embedders, implementation != 'all', and a model without "
                "internal id arithmetic (no reciprocal wrapper)"
            )
        if self._fused:
            self.config.log("Using fused (localized single-gather) scoring")

        # negatives drawn on the device: available when no filtering is
        # configured
        on_device = self.config.check(
            "negative_sampling.on_device", ["auto", "always", "never"]
        )
        filtering = bool(self._sampler.filter_positives.any())
        if on_device == "always" and filtering:
            raise ValueError(
                "negative_sampling.on_device=always is incompatible with "
                "filtering (positives lookup is host-side)"
            )
        self._on_device = (
            on_device == "always" or (on_device == "auto" and not filtering)
        )
        self._device_cdf = None
        if self._on_device:
            self.config.log("Drawing negative samples on-device")
            if self.config.get("negative_sampling.sampling_type") == "frequency":
                self._device_cdf = {
                    slot: torch.as_tensor(
                        self._sampler._cdf[slot], dtype=torch.float32,
                        device=self.device,
                    )
                    for slot in self._active_slots
                }

    def _scan_data(self):
        """The scanned epoch needs negatives drawn on the device; with
        ``on_device: never`` (the host sampler) epochs run batch by batch.
        kge_tpu also runs per-row ``batch`` batch by batch, on a TPU backend
        only (a compile-time cost there), so that route scans here."""
        if not self._on_device:
            return None
        return self._scan_data_triples()

    def _batches(self):
        perm = self._epoch_permutation(self.num_examples)
        bs = self.batch_size
        for start in range(0, self.num_examples, bs):
            idx = perm[start : start + bs]
            true_size = len(idx)
            triples = self.triples[idx].astype(np.int64)
            triples_padded = self._pad_batch(triples, bs)
            batch: Dict[str, np.ndarray] = {
                "triples": triples_padded,
                "mask": np.concatenate(
                    [np.ones(true_size, np.float32),
                     np.zeros(bs - true_size, np.float32)]
                ),
                "true_size": true_size,
            }
            if not self._on_device:
                for slot in self._active_slots:
                    neg = self._sampler.sample(triples_padded, slot)
                    if neg.kind == "plain":
                        batch[f"neg_samples_{slot}"] = neg.samples
                    else:
                        batch[f"neg_unique_{slot}"] = neg.unique_samples
                        batch[f"neg_gather_{slot}"] = neg.gather_map
            yield batch

    def _batch_wide(self, key):
        """A shared sample row, a pool and the distinct ids of the batch's
        per-row samples serve every row of the batch."""
        return key.startswith(("neg_unique_", "neg_pool_", "neg_distinct_"))

    def _complete_batch(self, batch):
        """The whole batch's negatives, drawn before a rank takes its rows;
        for per-row samples scored against their distinct ids (``batch``)
        also those ids (``neg_distinct_*``) and each sample's position among
        them (``neg_position_*``), so that every rank scores the whole
        batch's list, as one process does."""
        batch = self._with_negatives(batch)
        if self._implementation in ("batch", "pool"):
            for slot in self._active_slots:
                samples = batch.get(f"neg_samples_{slot}")
                if samples is None:
                    continue
                vocab = int(self._sampler.vocabulary_size[slot])
                uniq, inv = _bounded_unique(
                    samples.reshape(-1), min(samples.numel(), vocab))
                batch[f"neg_distinct_{slot}"] = uniq
                batch[f"neg_position_{slot}"] = inv.reshape(samples.shape)
        return batch

    def _draw_negatives_on_device(self, triples, slot):
        """Negatives drawn on the job's device from its generator (uniform
        or frequency-based, with replacement). Returns entries for the
        batch dict mirroring the host sampler's fixed-shape products.

        ``pool``: a group-structured pool of ``num * pool_factor`` iid
        candidates; each row independently picks one candidate per group of
        ``pool_factor``. Chosen candidates are distinct slots by
        construction and the pool is iid, so every row's ``num`` negatives
        are exactly iid draws from the sampling distribution (rows
        correlate only through the shared pool).

        Non-shared otherwise: [n, num] per-row samples.

        Shared: one sample row for the whole batch. For
        shared_type=default, one spare is drawn and each row's own positive
        (first match) is replaced by it; the replacement is an elementwise
        substitution of the spare score column."""
        num = int(self._sampler.num_samples[slot])
        n = triples.shape[0]
        vocab = int(self._sampler.vocabulary_size[slot])
        device = triples.device

        def draw(shape):
            if self._device_cdf is not None:
                u = torch.rand(shape, generator=self._generator, device=device)
                return torch.searchsorted(self._device_cdf[slot], u).clamp_max(
                    vocab - 1
                )
            return torch.randint(
                0, vocab, shape, generator=self._generator, device=device
            )

        if self._implementation == "pool" and not self._sampler.shared:
            pool = draw((num * self._pool_factor,))
            sel = torch.randint(
                0, self._pool_factor, (n, num), generator=self._generator,
                device=device,
            )
            return {f"neg_pool_{slot}": pool, f"neg_sel_{slot}": sel}
        if not self._sampler.shared:
            return {f"neg_samples_{slot}": draw((n, num))}

        sample = draw((num + 1,))
        out = {f"neg_unique_{slot}": sample}
        if self._sampler.shared_type == "default":
            pos = triples[:, slot]
            matches = sample[None, :num] == pos[:, None]
            out[f"neg_hasmatch_{slot}"] = matches.any(dim=1)
            # position of the first match (0 where there is none)
            out[f"neg_first_{slot}"] = torch.argmax(
                matches.to(torch.int8), dim=1
            )
        return out

    def _with_negatives(self, batch):
        """The batch with every active slot's negatives: those already in
        it (pre-drawn, or from the host sampler) stay."""
        batch = dict(batch)
        for slot in self._active_slots:
            if any(f"neg_{kind}_{slot}" in batch
                   for kind in ("unique", "samples", "pool")):
                continue
            if not self._on_device:
                raise ValueError(
                    f"batch holds no negatives for slot {SLOT_STR[slot]} and "
                    "negative_sampling.on_device is off"
                )
            batch.update(self._draw_negatives_on_device(batch["triples"], slot))
        return batch

    def _neg_from_unique_scores(self, all_scores, batch, slot, num):
        """[n, num] negative scores from the [n, num(+spares)] unique-target
        score matrix: negatives drawn on the device substitute the spare
        column for each row's own positive (elementwise); the host
        sampler's construction provides an explicit gather map."""
        if f"neg_first_{slot}" in batch:
            neg = all_scores[:, :num]
            spare = all_scores[:, num]
            first = batch[f"neg_first_{slot}"]
            has_match = batch[f"neg_hasmatch_{slot}"].bool()
            cols = torch.arange(num, device=all_scores.device)[None, :]
            replace = (cols == first[:, None]) & has_match[:, None]
            return torch.where(replace, spare[:, None], neg)
        if f"neg_gather_{slot}" in batch:
            # host sampler route only: columns repeat under with-replacement
            # sampling, and the pick sums their gradients in a fixed order
            return picked_scores(all_scores, batch[f"neg_gather_{slot}"])
        return all_scores[:, :num]

    def _neg_from_pool_scores(self, pool_scores, batch, slot, num):
        """[n, num] negatives from the [n, num * pool_factor] pool score
        matrix: each row selects its slot within every group of
        pool_factor columns (an elementwise one-hot contraction, whose
        backward is elementwise too)."""
        n = pool_scores.shape[0]
        sel = batch[f"neg_sel_{slot}"]
        pool_scores = pool_scores.reshape(n, num, self._pool_factor)
        one_hot = torch.nn.functional.one_hot(
            sel.long(), self._pool_factor
        ).to(pool_scores.dtype)
        return torch.sum(pool_scores * one_hot, dim=2)

    def _score_negatives(self, triples, slot, batch, tables):
        """Score the negatives of one slot -> [n, num], by the batch's kind
        of negatives (reference sampler.py:263-356)."""
        num = int(self._sampler.num_samples[slot])
        if f"neg_pool_{slot}" in batch:
            pool = batch[f"neg_pool_{slot}"]
            if getattr(self.model.get_scorer(), "pairwise_many_targets", False):
                # distance models: the [n, P] many-targets form is a
                # pairwise reduction; score each row's own candidates
                return self.model.score_spo_neg_pooled(
                    triples, pool, batch[f"neg_sel_{slot}"], self._pool_factor,
                    slot, tables=tables,
                )
            return self._neg_from_pool_scores(
                self._score_targets(triples, slot, pool, tables), batch, slot, num
            )
        if f"neg_unique_{slot}" in batch:
            all_scores = self._score_targets(
                triples, slot, batch[f"neg_unique_{slot}"], tables
            )
            return self._neg_from_unique_scores(all_scores, batch, slot, num)
        samples = batch[f"neg_samples_{slot}"]
        if self._implementation == "triple":
            # the kept slots are embedded once per row, only the corrupted
            # slot looks up n * num table rows
            return self.model.score_spo_neg(triples, samples, slot, tables=tables)
        if self._implementation == "all":
            # every row against the whole vocabulary, then its own columns
            all_scores = self._score_targets(triples, slot, None, tables)
            return self._pick_all(all_scores, samples, slot)
        # batch, and host-drawn samples of pool: score against the DISTINCT
        # ids of the batch's samples, then pick each row's own columns (the
        # reference's dedup, kge/util/sampler.py:307-344)
        n, num = samples.shape
        flat = samples.reshape(-1)
        if batch.get("__localized__"):
            # mini-table positions are distinct aranges already, in the
            # mini-table's id space: the dedup is the identity
            all_scores = self._score_targets(triples, slot, flat, tables)
            cols = torch.arange(n * num, device=flat.device).reshape(n, num)
            return picked_scores(all_scores, cols)
        if f"neg_distinct_{slot}" in batch:
            all_scores = self._score_targets(
                triples, slot, batch[f"neg_distinct_{slot}"], tables)
            return picked_scores(all_scores, batch[f"neg_position_{slot}"])
        vocab = int(self._sampler.vocabulary_size[slot])
        uniq, inv = _bounded_unique(flat, min(flat.numel(), vocab))
        all_scores = self._score_targets(triples, slot, uniq, tables)
        return picked_scores(all_scores, inv.reshape(n, num))

    def _pick_all(self, all_scores, samples, slot):
        """Each row's samples from its scores against the whole vocabulary
        of ``slot``; under a model axis the entity slots' scores are the
        rank's columns, picked where they are held."""
        shard = self.model.vocab_shard if slot != P else None
        if shard is None:
            return picked_scores(all_scores, samples)
        return picked_scores_columns(all_scores, samples, shard[0], shard[2])

    def _score_targets(self, triples, slot, targets, tables):
        if slot == S:
            return self.model.score_po(
                triples[:, P], triples[:, O], targets, tables=tables
            )
        elif slot == P:
            return self.model.score_so(
                triples[:, S], triples[:, O], targets, tables=tables
            )
        return self.model.score_sp(
            triples[:, S], triples[:, P], targets, tables=tables
        )

    def _grouped_multi_eligible(self) -> bool:
        """The embed-once path draws embedding dropout once per slot instead
        of once per scoring call; engage it only when no embedder dropout
        is configured (per-call-draw parity otherwise)."""
        return all(
            getattr(emb, "dropout", 0.0) == 0.0
            for emb in (self.model.get_s_embedder(), self.model.get_p_embedder())
        )

    def _fused_eligible(self) -> bool:
        """The fused path rewrites each batch to "localized" ids over
        mini-tables gathered once (``_localize_batch``): the backward then
        writes each table's gradient once, by one scatter, instead of once
        per lookup. Exact for any optimizer, penalty and dropout (penalties
        run on the whole tables in ``_loss_fn``; dropout acts on the
        looked-up rows). kge_tpu's conditions, refusal by refusal."""
        from kge_tpu_torch.models.base import LookupEmbedder

        if self._implementation == "all":
            return False  # full-vocabulary scoring reads the whole table
        if not getattr(self.model, "supports_localized_batches", True):
            return False
        return all(
            type(emb) is LookupEmbedder
            for emb in (self.model.get_s_embedder(), self.model.get_p_embedder())
        )

    def _grouped_targets(self, batch):
        """The targets of the embed-once path, {slot: ids or None (the whole
        vocabulary)}, and the kind of negatives they serve ("all", "unique",
        "pool"); None where the path does not apply (kge_tpu's conditions,
        train_negative_sampling.py:480-515)."""
        if not self._grouped_multi_eligible():
            return None
        slots = self._active_slots
        if self._implementation == "all" and all(
            f"neg_samples_{slot}" in batch for slot in slots
        ):
            return {slot: None for slot in slots}, "all"
        if self._sampler.shared:
            kind = "unique"
        elif self._implementation == "pool":
            kind = "pool"
        else:
            return None
        if not all(f"neg_{kind}_{slot}" in batch for slot in slots):
            return None
        return {slot: batch[f"neg_{kind}_{slot}"] for slot in slots}, kind

    def _loss_for_batch(self, batch, variant=None, tables=None):
        """Loss of one batch. ``tables`` is the (entity, relation)
        mini-table pair of a localized batch (row-sparse step); negatives
        not in the batch are drawn here. On the fused path the batch is
        localized here and its mini-tables gathered from the whole tables
        through ``embedding_gather``, so the scatter kernel writes each
        table's gradient once; the lookups into the mini-tables then
        launch it once each, into mini-table-sized gradients."""
        if self._fused and tables is None:
            from kge_tpu_torch.ops.embedding_ops import embedding_gather

            batch, ent_ids, rel_ids = self._localize_batch(batch)
            entity_embedder = self.model.get_s_embedder()
            if entity_embedder.row_range is not None:
                # assembled from the shards; the backward returns each
                # shard's rows their gradient
                ent_table = entity_embedder.lookup(ent_ids)
            else:
                ent_table = embedding_gather(entity_embedder.embeddings, ent_ids)
            tables = (
                ent_table,
                embedding_gather(self.model.get_p_embedder().embeddings, rel_ids),
            )
        batch = self._with_negatives(batch)
        triples = batch["triples"]
        mask = batch["mask"]
        batch_size = batch.get("__denom__", torch.sum(mask))
        total = torch.zeros((), device=triples.device)
        aux = {}
        grouped, kind = None, None
        targets = self._grouped_targets(batch)
        if targets is not None:
            # s, p and o are embedded once and the sample rows, the pools or
            # the whole vocabulary ("all") are the targets, so the backward
            # pass holds one lookup gradient per triple slot and one per
            # target list (none for the whole vocabulary: the product reads
            # the table itself). With "all" that is 3 scatter launches a
            # step for s, p and o. None for scorers that do not factorize
            # (the distance models).
            targets, kind = targets
            grouped = self.model.score_all_grouped_multi(
                triples, self._active_slots, targets, tables=tables
            )
        for slot in self._active_slots:
            num = int(self._sampler.num_samples[slot])
            if grouped is not None:
                pos_flat, all_scores = grouped[slot]
                if kind == "all":
                    neg = self._pick_all(all_scores, batch[f"neg_samples_{slot}"],
                                         slot)
                elif kind == "pool":
                    neg = self._neg_from_pool_scores(all_scores, batch, slot, num)
                else:
                    neg = self._neg_from_unique_scores(all_scores, batch, slot, num)
            else:
                pos_flat = self.model.score_spo(
                    triples[:, S], triples[:, P], triples[:, O],
                    direction=SLOT_STR[slot], tables=tables,
                )
                neg = self._score_negatives(triples, slot, batch, tables)
            scores = torch.cat([pos_flat.reshape(-1, 1), neg], dim=1)
            labels = torch.zeros(
                scores.shape[0], dtype=torch.long, device=scores.device
            )
            # padded rows are weighted out row by row
            per_row = self._per_row_loss(scores, labels)
            loss_value = torch.sum(per_row * mask) / batch_size
            total = total + loss_value
            aux[f"avg_loss_{SLOT_STR[slot]}"] = loss_value
        return total, aux

    # -- batch localization (row-sparse step) ------------------------------------

    def _localize_batch(self, batch):
        """Collect the global row ids the batch touches (in a fixed order)
        and rewrite the batch to mini-table positions. Returns (local_batch,
        ent_ids, rel_ids); gathering the tables at those ids yields
        mini-tables the rewritten batch indexes exactly."""
        batch = self._with_negatives(batch)
        triples = batch["triples"]
        n = triples.shape[0]
        arange = torch.arange(n, dtype=triples.dtype, device=triples.device)
        ent_ids = [triples[:, S], triples[:, O]]
        rel_ids = [triples[:, P]]
        # s -> [0, n), p -> [0, n) of the relation mini-table, o -> [n, 2n)
        local_triples = [arange, arange, n + arange]
        ent_off, rel_off = 2 * n, n
        for slot in self._active_slots:
            is_rel = slot == P
            ids, off = (rel_ids, rel_off) if is_rel else (ent_ids, ent_off)
            # a pool localizes like a shared unique list (the per-row
            # selection neg_sel is pool-relative and needs no rewrite);
            # per-row samples localize element by element
            key = next(f"neg_{kind}_{slot}" for kind in ("pool", "unique", "samples")
                       if f"neg_{kind}_{slot}" in batch)
            arr = batch[key]
            ids.append(arr.reshape(-1))
            batch[key] = off + torch.arange(
                arr.numel(), dtype=arr.dtype, device=arr.device
            ).reshape(arr.shape)
            off += arr.numel()
            if is_rel:
                rel_off = off
            else:
                ent_off = off
        batch["triples"] = torch.stack(local_triples, dim=1)
        batch["__localized__"] = True  # ids are mini-table positions now
        return (
            batch,
            torch.cat([a.reshape(-1) for a in ent_ids]),
            torch.cat([a.reshape(-1) for a in rel_ids]),
        )

    # -- sparse embedding update -------------------------------------------------

    def _sparse_update_eligible(self) -> bool:
        """Row-sparse table updates are exact when: the optimizer rule has
        zero-gradient fixed points (Adagrad/plain SGD, no weight decay), no
        penalty term touches whole tables, tables are not re-normalized
        after each step, and scoring never consumes the full vocabulary
        (implementation != "all"). In "auto" mode the path activates when
        the vocabulary is much larger than the rows a batch touches: that
        is where dense updates dominate the step. The decision is
        kge_tpu's, refusal by refusal."""
        from kge_tpu_torch.models.base import LookupEmbedder

        mode = self.config.check(
            "train.sparse_embedding_update", ["auto", "never", "always"]
        )
        if mode == "never" or self.is_forward_only:
            return False
        if self._implementation == "all":
            return False
        if self._subbatch_size > 0:
            return False
        # models with scorer parameters may collect statistics or dense
        # scorer gradients; they keep the standard step
        if any(True for _ in self.model.get_scorer().parameters()):
            return False
        # models with internal id arithmetic (reciprocal wrapper) cannot
        # consume localized batches
        if not getattr(self.model, "supports_localized_batches", True):
            return False
        for emb in (self.model.get_s_embedder(), self.model.get_p_embedder()):
            if type(emb) is not LookupEmbedder:
                return False
            if emb.normalize_p > 0:
                return False
        # whole-table penalties (unweighted lp/n3) make gradients dense
        device = self.device
        dummy = {"triples": torch.zeros((2, 3), dtype=torch.long, device=device),
                 "mask": torch.ones(2, device=device)}
        with torch.no_grad():
            if self.model.penalty(batch=dummy, epoch=1):
                return False
        self._ent_leaf = self.optimizer.leaf_index("entity_embedder", "embeddings")
        self._rel_leaf = self.optimizer.leaf_index("relation_embedder", "embeddings")
        if self._ent_leaf is None or self._rel_leaf is None:
            return False
        # every table leaf needs either the pure row path (zero-gradient
        # rows are fixed points: Adagrad/plain SGD) or kge_tpu's fused
        # dense-semantics kernel (any rule: Adam, weight decay, ...)
        for leaf in (self._ent_leaf, self._rel_leaf):
            if not (
                self.optimizer.supports_sparse_rows(leaf)
                or self.optimizer.supports_fused_rows(leaf)
            ):
                return False
        if mode == "always":
            return True
        # auto: worthwhile when the batch touches <= 1/8 of the entity table
        rows_per_batch = 2 * self.batch_size
        for slot in self._active_slots:
            num = int(self._sampler.num_samples[slot])
            if self._sampler.shared:
                rows_per_batch += num + 1
            elif self._implementation == "pool":
                rows_per_batch += num * self._pool_factor
            else:
                rows_per_batch += self.batch_size * num
        return self.dataset.num_entities() >= 8 * rows_per_batch

    def _build_step_fn(self):
        super()._build_step_fn()
        self._sparse_update = (
            not self.is_forward_only and self._sparse_update_eligible()
        )
        if not self._sparse_update:
            return
        fused_leaves = [
            leaf for leaf in (self._ent_leaf, self._rel_leaf)
            if not self.optimizer.supports_sparse_rows(leaf)
        ]
        self.config.log(
            "Using row-sparse embedding updates "
            + ("(fused dense-semantics kernel)" if fused_leaves
               else "(exact for this optimizer)")
        )
        self._train_step = self._sparse_step

    def _sparse_step(self, batch, lr, variant=None):
        """Train step that never materializes table-sized gradients: the
        loss is computed on gathered "mini-tables" whose rows are exactly
        the ones the batch touches (the batch's indexes localize to arange
        offsets), the gradient is taken with respect to the mini-tables,
        and the optimizer applies exact updates to the real tables in place
        from the row gradients: row writes where zero-gradient rows are
        fixed points of the rule, one fused pass over the table
        otherwise."""
        local_batch, ent_ids, rel_ids = self._localize_batch(batch)
        # the whole batch is localized on every rank, so the mini-tables'
        # rows are the same everywhere; each rank takes its rows' loss
        local_batch, rows = self._data_shard(local_batch)
        self._enter_step(rows)
        params = self.optimizer.params
        entity_embedder = self.model.get_s_embedder()
        with torch.no_grad():
            # from the shards of the entity table under a model axis
            ent_rows = entity_embedder.lookup(ent_ids)
            rel_rows = params[self._rel_leaf][rel_ids]
        ent_rows.requires_grad_(True)
        rel_rows.requires_grad_(True)
        loss_value, aux = self._loss_for_batch(
            local_batch, tables=(ent_rows, rel_rows)
        )
        g_ent_rows, g_rel_rows = torch.autograd.grad(
            loss_value, [ent_rows, rel_rows]
        )
        self.device_ctx.reduce_data(g_ent_rows)
        self.device_ctx.reduce_data(g_rel_rows)
        if entity_embedder.row_range is not None:
            # the rows this rank holds, as local ids
            lo, hi = entity_embedder.row_range
            own = (ent_ids >= lo) & (ent_ids < hi)
            ent_ids, g_ent_rows = ent_ids[own] - lo, g_ent_rows[own]
        self._optimizer_wrote = True
        self.optimizer.update_with_sparse_leaves(
            [None] * len(params), self.opt_state, lr,
            sparse={
                self._ent_leaf: (ent_ids, g_ent_rows),
                self._rel_leaf: (rel_ids, g_rel_rows),
            },
        )
        self.model.postprocess_params()
        aux = _detach(aux)
        aux["avg_loss"] = loss_value.detach()
        aux["penalties"] = {}
        return loss_value.detach(), aux

    def _per_row_loss(self, scores, labels):
        """Row-wise loss so padded rows can be masked out; sums over columns
        within a row (consistent with the reference's sum convention), in
        float32."""
        return self.loss.rows(scores.float(), labels)


def _bounded_unique(ids: torch.Tensor, size: int):
    """``jnp.unique(ids, size=size, fill_value=0, return_inverse=True)``:
    the sorted distinct ids padded with 0 to ``size`` (the padding's scores
    are computed and never picked), and each id's position among them. On
    CUDA the host waits for the card once here: ``torch.unique``'s output
    size is data-dependent."""
    uniq, inv = torch.unique(ids, sorted=True, return_inverse=True)
    if uniq.numel() < size:
        uniq = torch.cat([uniq, uniq.new_zeros(size - uniq.numel())])
    return uniq, inv
