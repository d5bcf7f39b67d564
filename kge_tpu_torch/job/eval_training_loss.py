"""Training-loss evaluation: a forward-only pass of the training job over the
evaluation split (reference kge/job/eval_training_loss.py; kge_tpu/job/
eval_training_loss.py).

kge_tpu computes this loss in train mode (``Ctx(train=True)``): dropout is
on and batch norm normalizes by the batch statistics. ``EvaluationJob._run``
puts the model in eval mode under ``torch.inference_mode()``; the
forward-only job's steps switch it to train mode, write no parameter,
statistic or optimizer state, and the mode the evaluation found is restored
after the epoch.
"""

from __future__ import annotations

import time
from typing import Any, Dict

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.job.eval import EvaluationJob
from kge_tpu_torch.job.job import Job


class TrainingLossEvaluationJob(EvaluationJob):
    def __init__(self, config: Config, dataset: Dataset, parent_job, model):
        super().__init__(config, dataset, parent_job, model)
        from kge_tpu_torch.job.train import TrainingJob

        training_loss_eval_config = config.clone()
        training_loss_eval_config.set("job.type", "train")
        training_loss_eval_config.set("train.split", self.eval_split)
        self._train_job = TrainingJob.create(
            config=training_loss_eval_config, parent_job=self,
            dataset=dataset, model=model, forward_only=True,
        )
        if self.__class__ == TrainingLossEvaluationJob:
            for f in Job.job_created_hooks:
                f(self)

    def _evaluate(self) -> Dict[str, Any]:
        epoch_start = time.time()
        self._train_job.epoch = self.epoch
        was_training = self.model.training
        try:
            train_trace_entry = self._train_job.run_epoch()
        finally:
            self.model.train(was_training)
        return dict(
            type="training_loss", scope="epoch",
            epoch=self.epoch, split=self.eval_split,
            epoch_time=time.time() - epoch_start,
            event="eval_completed",
            avg_loss=train_trace_entry["avg_loss"],
            avg_penalty=train_trace_entry["avg_penalty"],
            avg_cost=train_trace_entry["avg_cost"],
        )
