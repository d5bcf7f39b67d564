"""Filtered entity-ranking evaluation (reference kge/job/eval_entity_ranking.py;
kge_tpu/job/eval_entity_ranking.py).

For each test triple (s,p,o), all (s,p,?) and (?,p,o) completions are
scored over the entity range; ranks count strictly-greater scores excluding
ties (isclose with configurable tolerances), known positives are filtered
out, and final ranks follow the configured tie policy. Metrics (MRR, Hits@k,
mean rank — raw, filtered and filtered-with-test, plus head/tail,
relation-type, and frequency drill-downs) are computed from rank histograms.

Design: every batch is ranked once per direction by one of two routes,
which return the same four things: the raw (greater, close) counts, the
pivot (the true entity's own score, so that it ties with itself exactly)
and the scores at the batch's known positives, given per row in CSR form.
Filtered counts are the raw counts minus the positives' own (greater, close)
counts, clamped at 0, as kge_tpu's ``_rank_batch_grouped`` computes them.

- The rank kernel (ops/rank_kernel.py), for scorers that factorize
  (``factorized_queries``: ComplEx, the L2 distance scorers with their sqrt
  epilogue): the model's query against the entity table, one float32 FMA
  chain a score. The batch x |E| score matrix is never held on the card,
  and ``entity_ranking.chunk_size`` has nothing to bound there.
- The score matrix (``score_matrix_rank_counts``), for scorers that do not
  factorize (TransE and RotatE under L1 or L_p, TransH): kge_tpu's flat
  ``_rank_batch`` in plain PyTorch, since kge_tpu computes it outside any
  Pallas kernel. The sp_/_po scores are computed over entity chunks of
  ``entity_ranking.chunk_size`` columns (-1: all of |E| at once), so that
  the [n, chunk] matrix is what the card holds. The pivot is the true
  entity's own matrix entry; with more than one chunk a first pass over
  the chunks finds it.

The consistency check compares the pivot with the triple's true score and
warns (``entity_ranking.tie_handling.warn_only``) when they differ beyond
the tie tolerance, where kge_tpu warns: on the rank kernel's route the true
score is the spo score (kge_tpu's grouped route), on the score matrix's the
sp_/_po form at the batch's own answers (kge_tpu's flat route). The L2
factorization cancels for close pairs, so a trained L2 model may warn there,
as it does in kge_tpu.

Precision is float32 throughout: the job sets
``torch.backends.cuda.matmul.allow_tf32 = False`` and
``torch.backends.cudnn.allow_tf32 = False`` before it runs.
"""

from __future__ import annotations

import math
import time
from typing import Any, Dict, List, Tuple

import numpy as np
import torch

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.job.eval import EvaluationJob
from kge_tpu_torch.job.job import Job
from kge_tpu_torch.ops.rank_kernel import (
    close_greater,
    csr_row_sums,
    fused_rank_counts,
)

S, P, O = 0, 1, 2


def hist_all(hists, s, p, o, s_ranks, o_ranks, job, **kwargs):
    """Batch-wide rank histogram; also head/tail histograms when enabled
    (reference eval_entity_ranking.py:665-687)."""
    num_entities = job.dataset.num_entities()
    if "all" not in hists:
        hists["all"] = np.zeros(num_entities, dtype=np.float64)
    hists["all"] += np.bincount(s_ranks, minlength=num_entities)
    hists["all"] += np.bincount(o_ranks, minlength=num_entities)
    if job.head_and_tail:
        for key, ranks in (("head", s_ranks), ("tail", o_ranks)):
            if key not in hists:
                hists[key] = np.zeros(num_entities, dtype=np.float64)
            hists[key] += np.bincount(ranks, minlength=num_entities)


def hist_per_relation_type(hists, s, p, o, s_ranks, o_ranks, job, **kwargs):
    for rel_type, rels in job.dataset.index("relation_types").items():
        mask = np.isin(p, list(rels))
        key = rel_type
        if key not in hists:
            hists[key] = np.zeros(job.dataset.num_entities(), dtype=np.float64)
        np.add.at(hists[key], s_ranks[mask], 1)
        np.add.at(hists[key], o_ranks[mask], 1)
        if job.head_and_tail:
            for side, ranks in (("head", s_ranks), ("tail", o_ranks)):
                skey = f"{rel_type}_{side}"
                if skey not in hists:
                    hists[skey] = np.zeros(
                        job.dataset.num_entities(), dtype=np.float64
                    )
                np.add.at(hists[skey], ranks[mask], 1)


def hist_per_frequency_percentile(hists, s, p, o, s_ranks, o_ranks, job, **kwargs):
    """Subject buckets collect subject ranks, object buckets object ranks,
    and relation buckets BOTH rank sides (reference
    eval_entity_ranking.py:714-740)."""
    percentiles = job.dataset.index("frequency_percentiles")
    for arg, ranks, idx in (
        ("subject", s_ranks, s),
        ("relation", s_ranks, p),
        ("relation", o_ranks, p),
        ("object", o_ranks, o),
    ):
        for percentile, members in percentiles[arg].items():
            key = f"{arg}_{percentile}"
            if key not in hists:
                hists[key] = np.zeros(job.dataset.num_entities(), dtype=np.float64)
            mask = np.isin(idx, list(members))
            np.add.at(hists[key], ranks[mask], 1)


def has_ranking_route(model) -> bool:
    """Whether entity ranking can evaluate ``model``: every relational
    scorer can, by the rank kernel where it factorizes and by the score
    matrix of its sp_/_po forms (its own or the generic ones) otherwise."""
    from kge_tpu_torch.models.base import RelationalScorer

    return isinstance(model.get_scorer(), RelationalScorer)


def score_matrix_rank_counts(score_chunk, true: torch.Tensor,
                             cols: torch.Tensor, rows: torch.Tensor,
                             num_valid: int, chunk_size: int, atol: float,
                             rtol: float):
    """(greater [n] int32, close [n] int32, vals [nnz], pivot [n]), as
    ``fused_rank_counts`` returns them, from score matrices:
    ``score_chunk(start, stop)`` gives the [n, stop - start] scores of the
    candidate columns [start, stop), taken ``chunk_size`` at a time over
    ``[0, num_valid)``. The pivot is row i's own entry at column
    ``true[i]``; ``vals`` holds the entries at the CSR labels (``cols``,
    with ``rows`` the row of each). With more than one chunk a first pass
    finds the pivots and a second counts, each chunk scored by the same
    call both times."""
    n = true.shape[0]
    true = true.long()
    ranges = [(start, min(start + chunk_size, num_valid))
              for start in range(0, num_valid, chunk_size)]
    kept = None
    if len(ranges) == 1:
        kept = score_chunk(*ranges[0])
        pivot = kept.gather(1, true[:, None])[:, 0]
    else:
        pivot = None
        for start, stop in ranges:
            scores = score_chunk(start, stop)
            inside = (true >= start) & (true < stop)
            at = (true - start).clamp(0, stop - start - 1)
            entry = scores.gather(1, at[:, None])[:, 0]
            pivot = entry if pivot is None else torch.where(inside, entry, pivot)
    g = torch.zeros(n, dtype=torch.int32, device=true.device)
    c = torch.zeros(n, dtype=torch.int32, device=true.device)
    vals = torch.zeros(cols.shape[0], dtype=pivot.dtype, device=true.device)
    for start, stop in ranges:
        scores = kept if kept is not None else score_chunk(start, stop)
        close, greater = close_greater(scores, pivot[:, None], atol, rtol)
        g += greater.sum(dim=1, dtype=torch.int32)
        c += close.sum(dim=1, dtype=torch.int32)
        inside = (cols >= start) & (cols < stop)
        at = (cols.long() - start).clamp(0, stop - start - 1)
        vals = torch.where(inside, scores[rows, at], vals)
    return g, c, vals, pivot


def _csr(rows: np.ndarray, n: int):
    """row_ptr [n+1] of coordinates sorted by row."""
    return np.concatenate(
        [[0], np.cumsum(np.bincount(rows, minlength=n))]
    ).astype(np.int32)


class EntityRankingJob(EvaluationJob):
    def __init__(self, config: Config, dataset: Dataset, parent_job, model):
        super().__init__(config, dataset, parent_job, model)
        self.config.check(
            "entity_ranking.tie_handling.type",
            ["rounded_mean_rank", "best_rank", "worst_rank"],
        )
        self.tie_handling = config.get("entity_ranking.tie_handling.type")
        self.tie_atol = float(config.get("entity_ranking.tie_handling.atol"))
        self.tie_rtol = float(config.get("entity_ranking.tie_handling.rtol"))
        self.filter_with_test = config.get("entity_ranking.filter_with_test")
        self.filter_splits = list(config.get("entity_ranking.filter_splits"))
        if self.eval_split not in self.filter_splits:
            self.filter_splits.append(self.eval_split)
        # drop k's beyond the vocabulary (reference eval_entity_ranking.py:31-37)
        max_k = min(
            self.dataset.num_entities(),
            max(config.get("entity_ranking.hits_at_k_s")),
        )
        self.hits_at_k_s = [
            k for k in config.get("entity_ranking.hits_at_k_s") if k <= max_k
        ]
        self.head_and_tail = config.get("entity_ranking.metrics_per.head_and_tail")

        self.hist_hooks = [hist_all]
        if config.get("entity_ranking.metrics_per.relation_type"):
            self.hist_hooks.append(hist_per_relation_type)
        if config.get("entity_ranking.metrics_per.argument_frequency"):
            self.hist_hooks.append(hist_per_frequency_percentile)

        if self.__class__ == EntityRankingJob:
            for f in Job.job_created_hooks:
                f(self)

    def _prepare(self):
        super()._prepare()
        from kge_tpu_torch.utils.seed import apply_device_config

        apply_device_config(self.config)
        self.triples = self.dataset.split(self.eval_split)
        for split in self.filter_splits:
            self.dataset.index(f"{split}_sp_to_o")
            self.dataset.index(f"{split}_po_to_s")
        if "test" not in self.filter_splits and self.filter_with_test:
            self.dataset.index("test_sp_to_o")
            self.dataset.index("test_po_to_s")
        if self.config.get("entity_ranking.chunk_size") > -1:
            self.chunk_size = self.config.get("entity_ranking.chunk_size")
        else:
            self.chunk_size = self.dataset.num_entities()
        self.model.prepare_job(self)

    # -- label coords ----------------------------------------------------------

    def _label_coords(
        self, batch: np.ndarray, splits: List[str]
    ) -> Tuple[np.ndarray, np.ndarray]:
        """(row, col) coords of known positives over [0, 2E), sorted by row
        then column: sp labels in [0, E), po labels in [E, 2E). The triple's
        own answer is excluded (the reference instead zeroes it in the dense
        label matrix, eval_entity_ranking.py:282-290) and duplicates across
        splits are dropped (required for the subtraction design)."""
        E = self.dataset.num_entities()
        rows_all, cols_all = [], []
        for split in splits:
            sp = self.dataset.index(f"{split}_sp_to_o")
            po = self.dataset.index(f"{split}_po_to_s")
            r, v = sp.get_all_coords(batch[:, S], batch[:, P])
            keep = v != batch[r, O].astype(v.dtype)
            rows_all.append(r[keep])
            cols_all.append(v[keep].astype(np.int64))
            r, v = po.get_all_coords(batch[:, P], batch[:, O])
            keep = v != batch[r, S].astype(v.dtype)
            rows_all.append(r[keep])
            cols_all.append(v[keep].astype(np.int64) + E)
        rows = np.concatenate(rows_all)
        cols = np.concatenate(cols_all)
        packed = rows * (2 * E) + cols
        packed = np.unique(packed)
        return packed // (2 * E), packed % (2 * E)

    def _direction_labels(self, coords, union_member, n: int):
        """Split [0, 2E) coords into the per-direction CSR labels the rank
        kernel takes: {"o": (row_ptr, cols, rows, in_filt), "s": (...)};
        rows is each label's row (so that the device pass never waits for
        the host to size it), in_filt marks the coords that also belong to
        the ``_filt`` ranking (None when there is no ``_filt_test``
        ranking)."""
        E = self.dataset.num_entities()
        rows, cols = coords
        out = {}
        for key, is_side, offset in (("o", cols < E, 0), ("s", cols >= E, E)):
            r = rows[is_side]
            member = None if union_member is None else union_member[is_side]
            out[key] = (_csr(r, n), (cols[is_side] - offset).astype(np.int32),
                        r.astype(np.int64), member)
        return out

    # -- device pass -----------------------------------------------------------

    def _rank_batch(self, triples: torch.Tensor, labels,
                    rank_counts=fused_rank_counts) -> Tuple[Dict, torch.Tensor]:
        """Rank one batch. ``labels`` maps direction ("o": candidates for
        the object, "s": for the subject) to CSR (row_ptr, cols, rows,
        in_filt).
        Returns per-ranking [4, n] (s_rank, s_ties, o_rank, o_ties) plus the
        largest excess of |pivot - true score| over the tie tolerance. The
        route is the rank kernel when the model factorizes, else the score
        matrix. ``rank_counts`` lets a check run the same batch through the
        rank kernel's plain version."""
        E = self.dataset.num_entities()
        fac = self.model.factorized_queries(triples, (0, 2))
        atol, rtol = self.tie_atol, self.tie_rtol
        raw, filt, filt_test, excess = {}, {}, {}, []
        s, p, o = triples[:, S], triples[:, P], triples[:, O]
        for key, slot, true in (("o", 2, o), ("s", 0, s)):
            row_ptr, cols, rows, in_filt = labels[key]
            if fac is not None:
                pos, q, targets, score_map = fac[slot]
                g, c, vals, pivot = rank_counts(
                    q.contiguous(), targets.contiguous(), None, row_ptr, cols,
                    E, atol, rtol, score_map=score_map,
                    pivot_cols=true.to(torch.int32).contiguous(),
                )
            else:
                # the true score that kge_tpu's flat route checks against:
                # the sp_/_po form at the batch's own answers
                # (kge_tpu/job/eval_entity_ranking.py:336-339)
                if key == "o":
                    def score_chunk(start, stop):
                        return self.model.score_sp(s, p, self._entity_range(start, stop))
                    pos = torch.diagonal(self.model.score_sp(s, p, o))
                else:
                    def score_chunk(start, stop):
                        return self.model.score_po(p, o, self._entity_range(start, stop))
                    pos = torch.diagonal(self.model.score_po(p, o, s))
                g, c, vals, pivot = score_matrix_rank_counts(
                    score_chunk, true, cols, rows, E, self.chunk_size, atol, rtol
                )
            # consistency: the true score vs the ranking's own entry
            excess.append(torch.max(
                (pivot - pos).abs() - (atol + rtol * pos.abs())
            ))
            lab_close, lab_greater = close_greater(vals, pivot[rows], atol, rtol)
            raw[key] = (g, c)

            def minus(keep=None):
                gm, cm = lab_greater, lab_close
                if keep is not None:
                    gm, cm = gm & keep, cm & keep
                return (
                    torch.clamp_min(g - csr_row_sums(row_ptr, gm), 0),
                    torch.clamp_min(c - csr_row_sums(row_ptr, cm), 0),
                )

            if in_filt is None:
                filt[key] = minus()
            else:
                filt[key] = minus(in_filt)
                filt_test[key] = minus()
        results = {"_raw": raw, "_filt": filt}
        if filt_test:
            results["_filt_test"] = filt_test
        results = {
            r: torch.stack([v["s"][0], v["s"][1], v["o"][0], v["o"][1]])
            for r, v in results.items()
        }
        return results, torch.max(torch.stack(excess))

    def _entity_range(self, start: int, stop: int):
        """The entity ids [start, stop), or None for all of them."""
        if start == 0 and stop == self.dataset.num_entities():
            return None
        return torch.arange(start, stop, device=self.model.device)

    def _final_rank(self, rank, num_ties):
        if self.tie_handling == "rounded_mean_rank":
            return rank + num_ties // 2
        elif self.tie_handling == "best_rank":
            return rank
        elif self.tie_handling == "worst_rank":
            return rank + num_ties - 1
        raise NotImplementedError

    # -- evaluation loop -------------------------------------------------------

    def _evaluate(self) -> Dict[str, Any]:
        if not self._is_prepared:
            self._prepare()
            self._is_prepared = True
        epoch_start = time.time()
        filter_with_test = (
            "test" not in self.filter_splits and self.filter_with_test
        )
        rankings = (
            ["_raw", "_filt", "_filt_test"] if filter_with_test
            else ["_raw", "_filt"]
        )

        num_batches = math.ceil(len(self.triples) / self.batch_size)
        self.current_trace["epoch"] = dict(
            type="entity_ranking", scope="epoch", split=self.eval_split,
            filter_splits=self.filter_splits, epoch=self.epoch,
            batches=num_batches, size=len(self.triples),
        )
        for f in self.pre_epoch_hooks:
            f(self)

        hists: Dict[str, Dict[str, np.ndarray]] = {
            r[1:] or "raw": {} for r in rankings
        }

        # host pass: pad every batch and build its CSR labels. The eval data
        # (triples, filter labels) is static for the job, so the collated
        # tensors are built once and reused across validation epochs.
        # Per-batch hooks/tracing see the batches only on the building pass.
        cached = getattr(self, "_collate_cache", None)
        if cached is None:
            cached = self._collate(filter_with_test)
        batches, device_batches = cached

        # device pass: results stay on the device until one fetch at the end
        results_all = {r: [] for r in rankings}
        excess_all = []
        for triples, labels in device_batches:
            results, excess = self._rank_batch(triples, labels)
            for r in rankings:
                results_all[r].append(results[r])
            excess_all.append(excess)
        fetched = {
            r: torch.stack(v).cpu().numpy() for r, v in results_all.items()
        }  # each [B, 4, n]
        max_diff = float(torch.max(torch.stack(excess_all)).cpu())

        # ranks for all batches vectorized host-side
        trace_examples = self.config.get("eval.trace_level") == "example"
        cat_ranks = {}
        for r in rankings:
            res = fetched[r]
            cat_ranks[r] = (
                self._final_rank(res[:, 0], res[:, 1]),
                self._final_rank(res[:, 2], res[:, 3]),
            )

        if max_diff > 0:
            msg = (
                "Error in tie-handling: spo and sp_/_po scores differ "
                "beyond the configured tolerances "
                f"(max excess {max_diff:.3e})."
            )
            if self.config.get("entity_ranking.tie_handling.warn_only"):
                self.config.log("WARNING: " + msg)
            else:
                raise ValueError(msg)

        s_cat = np.concatenate([b[:n_true, S] for b, n_true, _ in batches])
        p_cat = np.concatenate([b[:n_true, P] for b, n_true, _ in batches])
        o_cat = np.concatenate([b[:n_true, O] for b, n_true, _ in batches])
        for r in rankings:
            key = r[1:] or "raw"
            s_rank_all, o_rank_all = cat_ranks[r]
            # padded rows of the last batch never reach a histogram
            s_ranks = np.concatenate([
                s_rank_all[i][:n_true] for i, (_, n_true, _) in enumerate(batches)
            ])
            o_ranks = np.concatenate([
                o_rank_all[i][:n_true] for i, (_, n_true, _) in enumerate(batches)
            ])
            for f in self.hist_hooks:
                f(hists[key], s_cat, p_cat, o_cat, s_ranks, o_ranks, self)

        if trace_examples:
            for i, (batch, n_true, _) in enumerate(batches):
                batch_ranks = {
                    r: (cat_ranks[r][0][i][:n_true], cat_ranks[r][1][i][:n_true])
                    for r in rankings
                }
                self._trace_examples(batch, batch_ranks, rankings)

        metrics: Dict[str, Any] = {}
        suffix_of = {"_raw": "", "_filt": "_filtered", "_filt_test": "_filtered_with_test"}
        for r in rankings:
            suffix = suffix_of[r]
            key = r[1:] or "raw"
            for hist_key, hist in hists[key].items():
                hs = "" if hist_key == "all" else "_" + hist_key
                metrics.update(
                    self._compute_metrics(hist, suffix=suffix + hs)
                )

        epoch_time = time.time() - epoch_start
        self.current_trace["epoch"].update(
            dict(epoch_time=epoch_time, event="eval_completed", **metrics)
        )
        for f in self.post_epoch_hooks:
            f(self)
        trace_entry = dict(self.current_trace["epoch"])
        self.current_trace["epoch"] = None
        return trace_entry

    def _collate(self, filter_with_test: bool):
        """Pad every batch to ``batch_size`` by repeating its last triple
        and build its per-direction CSR labels on the model's device; cached
        when no per-batch hooks are registered."""
        device = self.model.device
        n = self.batch_size
        batches, device_batches = [], []
        for batch_number in range(0, len(self.triples), n):
            batch = self.triples[batch_number : batch_number + n]
            n_true = len(batch)
            padded = np.concatenate(
                [batch, np.repeat(batch[-1:], n - n_true, axis=0)]
            ) if n_true < n else batch
            padded = padded.astype(np.int64)

            self.current_trace["batch"] = dict(
                type="entity_ranking", scope="batch", split=self.eval_split,
                epoch=self.epoch, batch=batch_number // n, size=n_true,
            )
            for f in self.pre_batch_hooks:
                f(self)

            filt = self._label_coords(padded, self.filter_splits)
            if filter_with_test:
                # _filt_test filters the union of filter_splits and test
                # (the reference applies test labels on top of the already
                # filtered scores, eval_entity_ranking.py:277-313); one
                # kernel pass over the union serves both rankings, split
                # by a membership mask
                E2 = 2 * self.dataset.num_entities()
                coords = self._label_coords(padded, self.filter_splits + ["test"])
                member = np.isin(coords[0] * E2 + coords[1],
                                 filt[0] * E2 + filt[1])
            else:
                coords, member = filt, None
            labels = {
                key: tuple(
                    None if a is None else torch.as_tensor(a, device=device)
                    for a in value
                )
                for key, value in self._direction_labels(coords, member, n).items()
            }
            triples = torch.as_tensor(padded, device=device)
            batches.append((batch, n_true, padded))
            device_batches.append((triples, labels))

            if "batch" in self.current_trace and self.current_trace["batch"]:
                for f in self.post_batch_hooks:
                    f(self)
                self.current_trace["batch"] = None
        cached = (batches, device_batches)
        if not self.pre_batch_hooks and not self.post_batch_hooks:
            self._collate_cache = cached
        return cached

    def _trace_examples(self, batch, batch_ranks, rankings):
        for i in range(len(batch)):
            entry = dict(
                type="entity_ranking", scope="example", split=self.eval_split,
                epoch=self.epoch,
                s=int(batch[i, S]), p=int(batch[i, P]), o=int(batch[i, O]),
            )
            for r in rankings:
                suffix = {"_raw": "", "_filt": "_filtered",
                          "_filt_test": "_filtered_with_test"}[r]
                entry[f"rank_s{suffix}"] = int(batch_ranks[r][0][i]) + 1
                entry[f"rank_o{suffix}"] = int(batch_ranks[r][1][i]) + 1
            self.config.trace(**entry)

    def _compute_metrics(self, rank_hist: np.ndarray, suffix="") -> Dict[str, Any]:
        """MRR / Hits@k / mean rank from a rank histogram
        (reference eval_entity_ranking.py:620-648). Histogram index is the
        0-based rank; metrics use 1-based ranks."""
        metrics = {}
        n = float(np.sum(rank_hist))
        ranks = np.arange(1, len(rank_hist) + 1, dtype=np.float64)
        metrics["mean_rank" + suffix] = (
            float(np.sum(rank_hist * ranks) / n) if n > 0 else 0.0
        )
        metrics["mean_reciprocal_rank" + suffix] = (
            float(np.sum(rank_hist / ranks) / n) if n > 0 else 0.0
        )
        max_k = max(self.hits_at_k_s)
        hits = (
            np.cumsum(rank_hist[:max_k]) / n if n > 0 else np.zeros(max_k)
        )
        for k in self.hits_at_k_s:
            metrics[f"hits_at_{k}{suffix}"] = float(hits[k - 1])
        return metrics
