"""KvsAll training (reference kge/job/train_KvsAll.py; kge_tpu/job/
train_KvsAll.py).

Examples are the unique (s, p), (p, o) and, if enabled, (s, o) queries of
the training split; each is scored against its whole candidate vocabulary
with a multi-hot label row. Labels come as coordinate lists from the KvsAll
index (bucketed to a multiple of 256, padded coordinates pointing at the
dropped row ``batch_size``) and are made dense on the device. Under a model
axis the entity queries (sp_, _po) score a rank's batch rows against the
entity rows it holds, and the labels are cut to those columns: a rank never
holds a [batch, |E|] matrix; the loss is taken over the column shards
(ops/losses.py), label smoothing counting the whole vocabulary.

Batches are homogeneous in query type, as in kge_tpu: each type's queries
are shuffled, cut into batches, and the batches of all types come in one
random order. ``_step_variant`` tags a batch with its query type, which
selects the scoring function of the step. The scanned epoch
(``train.epoch_scan``, kge_tpu/job/train_KvsAll.py:209-322) trains the same
batches grouped by query type, in the order of the batch stream within each
type: each type's batches are stacked once an epoch (label coordinates
padded to a sticky cap in buckets of 2,048, the padding at the dropped row),
copied to the card in one copy an array, and stepped through in one pass a
type, the optimizer state chaining across the passes.
"""

from __future__ import annotations

import time
from typing import Dict, List

import numpy as np
import torch

from kge_tpu_torch.job.job import Job
from kge_tpu_torch.job.train import TrainingJob, _stack_scalars, _step_scalars
from kge_tpu_torch.utils.dtypes import weak

S, P, O = 0, 1, 2

_QUERY_TYPES = ["sp_", "s_o", "_po"]


def _bucket(n: int, quantum: int = 256) -> int:
    return max(quantum, ((n + quantum - 1) // quantum) * quantum)


class TrainingJobKvsAll(TrainingJob):
    def __init__(self, config, dataset, parent_job=None, model=None,
                 forward_only=False):
        super().__init__(config, dataset, parent_job, model=model,
                         forward_only=forward_only)
        self.label_smoothing = config.check_range(
            "KvsAll.label_smoothing", float("-inf"), 1.0, max_inclusive=False
        )
        if self.label_smoothing < 0:
            if config.get("job.auto_correct"):
                config.log(
                    "Setting KvsAll.label_smoothing to 0, "
                    f"was set to {self.label_smoothing}."
                )
                self.label_smoothing = 0
            else:
                raise Exception(
                    "Label_smoothing was set to {}, "
                    "should be at least 0.".format(self.label_smoothing)
                )
        elif self.label_smoothing > 0 and self.label_smoothing <= (
            1.0 / dataset.num_entities()
        ):
            if config.get("job.auto_correct"):
                # just to be sure it's used correctly
                self.label_smoothing = 1.0 / dataset.num_entities()
                config.log(
                    "Setting KvsAll.label_smoothing to 1/num_entities = {}, "
                    "was set to {}.".format(
                        1.0 / dataset.num_entities(), self.label_smoothing
                    )
                )
            else:
                raise Exception(
                    "Label_smoothing was set to {}, "
                    "should be at least {}.".format(
                        self.label_smoothing, 1.0 / dataset.num_entities()
                    )
                )

        self.config.log("Initializing KvsAll training job...")
        if self.__class__ == TrainingJobKvsAll:
            for f in Job.job_created_hooks:
                f(self)

    @property
    def type_str(self):
        return "KvsAll"

    def _prepare_data(self):
        self.query_indexes = {}
        self.query_types: List[str] = []
        for qtype in _QUERY_TYPES:
            if self.config.get(f"KvsAll.query_types.{qtype}"):
                self.query_types.append(qtype)
                key = {"sp_": "sp", "s_o": "so", "_po": "po"}[qtype]
                value = {"sp_": "o", "s_o": "p", "_po": "s"}[qtype]
                self.query_indexes[qtype] = self.dataset.index(
                    f"{self.train_split}_{key}_to_{value}"
                )
        if not self.query_types:
            raise ValueError("KvsAll requires at least one enabled query type")
        self.num_examples = sum(
            len(self.query_indexes[t]) for t in self.query_types
        )

    def _vocab_size(self, qtype: str) -> int:
        return (
            self.dataset.num_relations() if qtype == "s_o"
            else self.dataset.num_entities()
        )

    def _batches(self):
        # one stream of (type, query-row) examples, shuffled per type, with
        # homogeneous batches interleaved in random order (kge_tpu's draws
        # from the job's generator, in its order)
        bs = self.batch_size
        chunks = []
        for qtype in self.query_types:
            index = self.query_indexes[qtype]
            perm = self._epoch_permutation(len(index))
            for start in range(0, len(index), bs):
                chunks.append((qtype, perm[start : start + bs]))
        order = self._np_rng.permutation(len(chunks))
        for ci in order:
            qtype, rows = chunks[ci]
            index = self.query_indexes[qtype]
            true_size = len(rows)
            keys = index.keys()[rows].astype(np.int64)  # [b, 2]
            keys = self._pad_batch(keys, bs)
            # label coordinates for the batch (query row, value)
            counts = index._values_offset[rows + 1] - index._values_offset[rows]
            total = int(counts.sum())
            cap = _bucket(total)
            label_rows = np.full(cap, bs, dtype=np.int64)  # bs = dropped
            label_cols = np.zeros(cap, dtype=np.int64)
            qrows = np.repeat(np.arange(true_size), counts)
            starts = index._values_offset[rows]
            cum = np.concatenate([[0], np.cumsum(counts)])
            flat = np.arange(total)
            value_idx = starts[qrows] + (flat - cum[qrows])
            label_rows[:total] = qrows
            label_cols[:total] = index._values[value_idx]
            yield {
                "qtype": qtype,
                "queries": keys,
                "label_rows": label_rows,
                "label_cols": label_cols,
                "mask": np.concatenate(
                    [np.ones(true_size, np.float32),
                     np.zeros(bs - true_size, np.float32)]
                ),
                "true_size": true_size,
            }

    def _step_variant(self, batch):
        return batch["qtype"]

    # -- the scanned epoch ---------------------------------------------------------

    def _scan_data(self):
        """A marker: the batches are stacked each epoch
        (``_dispatch_epoch_scanned``), since their label coordinates depend
        on the epoch's shuffle."""
        return {"__size__": self.num_examples, "__kvsall__": 1}

    def _stack_epoch_batches(self):
        """This epoch's batches grouped by query type and stacked into
        ``[batches, ...]`` arrays, with one coordinate cap a type (kge_tpu's
        ``_stack_epoch_batches``)."""
        per: Dict[str, List[Dict]] = {}
        for batch in self._batches():
            per.setdefault(batch["qtype"], []).append(batch)
        stacks = {}
        if not hasattr(self, "_scan_caps"):
            self._scan_caps = {}
        bs = self.batch_size
        for qtype, batches in per.items():
            nb = len(batches)
            # sticky cap: the largest coordinate count seen so far, bucketed
            cap = max(
                _bucket(max(len(b["label_rows"]) for b in batches), 2048),
                self._scan_caps.get(qtype, 0),
            )
            self._scan_caps[qtype] = cap
            rows = np.full((nb, cap), bs, dtype=np.int64)
            cols = np.zeros((nb, cap), dtype=np.int64)
            for i, b in enumerate(batches):
                rows[i, : len(b["label_rows"])] = b["label_rows"]
                cols[i, : len(b["label_cols"])] = b["label_cols"]
            stacks[qtype] = dict(
                queries=np.stack([b["queries"] for b in batches]).astype(np.int64),
                mask=np.stack([b["mask"] for b in batches]),
                label_rows=rows, label_cols=cols,
            )
        return stacks

    def _dispatch_epoch_scanned(self, data):
        """One pass a query type over its stacked batches, on the card; the
        per-batch scalars of all types stay there for one fetch."""
        epoch_start = time.time()
        stacks = self._stack_epoch_batches()
        stacks = {
            qtype: {k: torch.as_tensor(v).to(self.device) for k, v in st.items()}
            for qtype, st in stacks.items()
        }
        prepare_time = time.time() - epoch_start
        lr = self._current_lrs()
        scalars = []
        for qtype, st in stacks.items():
            for i in range(st["queries"].shape[0]):
                batch = {k: v[i] for k, v in st.items()}
                cost, aux = self._step_with_retries(batch, lr, qtype)
                scalars.append(_step_scalars(cost, aux, batch["mask"]))
        return _stack_scalars(scalars), dict(epoch_start=epoch_start,
                                             prepare_time=prepare_time)

    def _batch_wide(self, key):
        """The label coordinates name rows of the whole batch: every
        subbatch takes them all and keeps its own rows."""
        return key in ("label_rows", "label_cols")

    def _dense_labels(self, batch, qtype: str, dtype=torch.float32,
                      columns=None) -> torch.Tensor:
        """The batch's [batch_size, vocab] 0/1 label matrix in ``dtype``
        (the scores'): the coordinates set in a matrix with one extra row,
        which takes the padded coordinates and is dropped. In a subbatch
        the coordinates' rows refer to the whole batch and are moved by
        ``__row_offset__``; rows outside the subbatch go to the dropped row
        too. ``columns`` (lo, hi): the label matrix of those columns only,
        the coordinates of the others sent to the dropped row."""
        bs = batch["queries"].shape[0]
        lo, hi = columns or (0, self._vocab_size(qtype))
        labels = torch.zeros(
            (bs + 1, hi - lo), dtype=dtype, device=batch["queries"].device,
        )
        rows = batch["label_rows"].long() - batch.get("__row_offset__", 0)
        cols = batch["label_cols"].long()
        keep = (rows >= 0) & (rows < bs)
        if columns is not None:
            keep = keep & (cols >= lo) & (cols < hi)
            cols = torch.where(keep, cols - lo, 0)
        rows = torch.where(keep, rows, bs)
        labels.index_put_(
            (rows, cols),
            torch.ones((), dtype=labels.dtype, device=labels.device),
        )
        return labels[:bs]

    def _loss_for_batch(self, batch, variant=None):
        qtype = variant
        queries = batch["queries"]
        mask = batch["mask"]
        batch_size = batch.get("__denom__", torch.sum(mask))

        if qtype == "sp_":
            scores = self.model.score_sp(queries[:, 0], queries[:, 1])
        elif qtype == "_po":
            scores = self.model.score_po(queries[:, 0], queries[:, 1])
        elif qtype == "s_o":
            scores = self.model.score_so(queries[:, 0], queries[:, 1])
        else:
            raise ValueError(f"not a KvsAll query type: {qtype!r}")

        # under a model axis the entity queries' columns are the rank's
        shard = None if qtype == "s_o" else self.model.vocab_shard
        # in the scores' dtype, smoothed there, as kge_tpu builds them
        labels = self._dense_labels(batch, qtype, scores.dtype,
                                    None if shard is None else shard[:2])
        if self.label_smoothing > 0 and qtype != "s_o":
            labels = weak(1.0 - self.label_smoothing, labels) * labels + weak(
                1.0 / self.dataset.num_entities(), labels)

        per_row = self.loss.rows(scores.float(), labels.float(), shard=shard)
        return torch.sum(per_row * mask) / batch_size, {}
