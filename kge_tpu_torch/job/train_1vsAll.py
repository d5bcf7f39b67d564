"""1vsAll training (reference kge/job/train_1vsAll.py; kge_tpu/job/
train_1vsAll.py).

Each triple is scored against all subject and all object corruptions; the
loss of each direction is the loss of the row against its true index,
weighted by the padding mask and divided by the true batch size. The two
[batch, |E|] score matrices are plain matrix products; every lookup's
backward is the scatter kernel when the job selects it (four lookups a step
on the reciprocal relations model: s, p, o and p + |R|). Under a model axis
a rank scores its batch rows against the entity rows it holds, [batch / D,
|E| / M] (kge_tpu's ring schedule where it engages, parallel/ring.py), and
the loss of each row is taken over the column shards (ops/losses.py).
"""

from __future__ import annotations

import numpy as np
import torch

from kge_tpu_torch.job.job import Job
from kge_tpu_torch.job.train import TrainingJob

S, P, O = 0, 1, 2


class TrainingJob1vsAll(TrainingJob):
    def __init__(self, config, dataset, parent_job=None, model=None,
                 forward_only=False):
        super().__init__(config, dataset, parent_job, model=model,
                         forward_only=forward_only)
        self.config.log("Initializing 1vsAll training job...")
        if self.__class__ == TrainingJob1vsAll:
            for f in Job.job_created_hooks:
                f(self)

    @property
    def type_str(self):
        return "1vsAll"

    def _prepare_data(self):
        self.triples = self.dataset.split(self.train_split)
        self.num_examples = len(self.triples)

    def _scan_data(self):
        return self._scan_data_triples()

    def _batches(self):
        perm = self._epoch_permutation(self.num_examples)
        bs = self.batch_size
        for start in range(0, self.num_examples, bs):
            idx = perm[start : start + bs]
            true_size = len(idx)
            triples = self._pad_batch(self.triples[idx].astype(np.int64), bs)
            yield {
                "triples": triples,
                "mask": np.concatenate(
                    [np.ones(true_size, np.float32),
                     np.zeros(bs - true_size, np.float32)]
                ),
                "true_size": true_size,
            }

    def _loss_for_batch(self, batch, variant=None):
        triples = batch["triples"]
        mask = batch["mask"]
        batch_size = batch.get("__denom__", torch.sum(mask))

        # object direction: score (s, p, ?) against all entities
        sp_scores = self.model.score_sp(triples[:, S], triples[:, P])
        loss_o = self._row_loss(sp_scores, triples[:, O], mask) / batch_size

        # subject direction: score (?, p, o) against all entities
        po_scores = self.model.score_po(triples[:, P], triples[:, O])
        loss_s = self._row_loss(po_scores, triples[:, S], mask) / batch_size

        return loss_o + loss_s, {"avg_loss_o": loss_o, "avg_loss_s": loss_s}

    def _row_loss(self, scores, labels, mask):
        """The loss of each row against its label, masked and summed."""
        rows = self.loss.rows(scores.float(), labels, shard=self.model.vocab_shard)
        return torch.sum(rows * mask)
