"""Evaluation job base (reference kge/job/eval.py; kge_tpu/job/eval.py)."""

from __future__ import annotations

import math
from typing import Any, Dict

import torch

from kge_tpu_torch import misc
from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.job.job import Job, TrainingOrEvaluationJob


class EvaluationJob(TrainingOrEvaluationJob):
    def __init__(self, config: Config, dataset: Dataset, parent_job, model):
        super().__init__(config, dataset, parent_job, model)
        self.batch_size = config.get("eval.batch_size")
        self.eval_split = self.config.get("eval.split")
        self.epoch = -1

        #: hooks called after computing the ranks of each batch
        self.hist_hooks = []

        if self.__class__ == EvaluationJob:
            for f in Job.job_created_hooks:
                f(self)

    @staticmethod
    def create(config: Config, dataset: Dataset, parent_job=None, model=None):
        """Factory by ``eval.type``."""
        eval_type = config.get("eval.type")
        class_name = config.get_default(eval_type + ".class_name")
        return misc.init_from(
            class_name, config.get("modules"),
            config, dataset, parent_job=parent_job, model=model,
        )

    @staticmethod
    def create_from(checkpoint: Dict, new_config: Config = None,
                    dataset: Dataset = None, parent_job=None) -> Job:
        """Create an evaluation job for the model stored in a checkpoint
        (written by kge_tpu or by this package)."""
        from kge_tpu_torch.models import KgeModel

        config = Config.create_from(checkpoint)
        if new_config:
            config.load_config(new_config)
        config.set("job.type", "eval")
        dataset = Dataset.create_from(checkpoint, config, dataset)
        model = KgeModel.create_from(
            checkpoint, dataset=dataset, use_tmp_log_folder=False,
            new_config=new_config,
        )
        job = EvaluationJob.create(config, model.dataset, parent_job, model)
        job.epoch = checkpoint.get("epoch", -1)
        return job

    def _load(self, checkpoint: Dict):
        super()._load(checkpoint)
        if "epoch" in checkpoint:
            self.epoch = checkpoint["epoch"]
        self.resumed_from_job_id = checkpoint.get("job_id")

    def _run(self) -> Dict[str, Any]:
        if self.model is None:
            raise ValueError("evaluation requires a model")
        self.config.log(
            "Evaluating on {} data (epoch {})...".format(self.eval_split, self.epoch)
        )
        was_training = self.model.training
        self.model.eval()
        try:
            with torch.inference_mode():
                trace_entry = self._evaluate()
        finally:
            self.model.train(was_training)

        # if validation metric is not present, try to compute it
        metric_name = self.config.get("valid.metric")
        if metric_name not in trace_entry:
            trace_entry[metric_name] = eval(
                self.config.get("valid.metric_expr"),
                None,
                dict(config=self.config, math=math, **trace_entry),
            )
        trace_entry = self.trace(**trace_entry, echo=False, log=True)
        from kge_tpu_torch.job.trace import format_trace_entry

        self.config.log(
            format_trace_entry("eval_epoch", trace_entry, self.config),
            prefix="  ",
        )
        return trace_entry

    def _evaluate(self) -> Dict[str, Any]:
        """Compute evaluation metrics, returning the (unwritten) trace entry."""
        raise NotImplementedError
