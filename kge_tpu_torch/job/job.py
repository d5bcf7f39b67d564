"""Job base classes.

Mirrors the reference job lifecycle (kge/job/job.py) as kge_tpu does
(kge_tpu/job/job.py): uuid job ids, parent/resumed-from lineage, creation
hooks (trace + per-job config snapshot), ``run()`` = pre hooks + ``_run`` +
post hooks, and the training-or-evaluation hook surface (pre/post batch/epoch
hooks plus a ``current_trace`` dict that hooks may mutate). ``job.type``
is ``train``, ``eval`` or ``search`` (job/search.py, job/search_grash.py).
"""

from __future__ import annotations

import os
import uuid
from typing import Any, Callable, Dict, List, Optional

from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset


def _trace_job_creation(job: "Job"):
    """Log a trace entry when a job is created."""
    userhome = os.path.expanduser("~")
    folder_str = (
        job.config.folder.replace(userhome, "~") if job.config.folder else ""
    )
    job.trace_entry = job.config.trace(
        git_head="", folder=folder_str, event="job_created",
    )


def _save_job_config(job: "Job"):
    """Save a copy of the job's config in the experiment folder."""
    if job.config.folder and os.path.isdir(
        os.path.join(job.config.folder, "config")
    ):
        job.config.save(
            os.path.join(job.config.folder, "config", job.job_id[0:8] + ".yaml")
        )


class Job(Configurable):
    #: hooks run when a job is created (reference job.py:40-43)
    job_created_hooks: List[Callable[["Job"], Any]] = [
        _trace_job_creation,
        _save_job_config,
    ]

    def __init__(self, config: Config, dataset: Dataset,
                 parent_job: Optional["Job"] = None, model=None):
        super().__init__(config)
        self.config = config
        self.dataset = dataset
        self.job_id = str(uuid.uuid4())
        self.parent_job = parent_job
        self.resumed_from_job_id: Optional[str] = None
        self.trace_entry: Dict[str, Any] = {}
        self.model = model
        self._is_prepared = False

        #: hooks before and after running the job
        self.pre_run_hooks: List[Callable[["Job"], Any]] = []
        self.post_run_hooks: List[Callable[["Job", Dict], Any]] = []

        if self.__class__ == Job:
            for f in Job.job_created_hooks:
                f(self)

    # -- factories ------------------------------------------------------------

    @staticmethod
    def create(config: Config, dataset: Optional[Dataset] = None,
               parent_job: Optional["Job"] = None, model=None,
               forward_only: bool = False) -> "Job":
        """Create a job by ``job.type``."""
        from kge_tpu_torch.job.eval import EvaluationJob
        from kge_tpu_torch.job.search import SearchJob
        from kge_tpu_torch.job.train import TrainingJob

        if dataset is None:
            dataset = Dataset.create(config)
        job_type = config.get("job.type")
        if job_type == "train":
            return TrainingJob.create(
                config, dataset, parent_job=parent_job, model=model,
                forward_only=forward_only,
            )
        elif job_type == "eval":
            return EvaluationJob.create(
                config, dataset, parent_job=parent_job, model=model
            )
        elif job_type == "search":
            return SearchJob.create(config, dataset, parent_job=parent_job)
        raise ValueError(f"unknown job type {job_type}")

    @staticmethod
    def create_from(checkpoint: Dict, new_config: Optional[Config] = None,
                    dataset: Optional[Dataset] = None,
                    parent_job: Optional["Job"] = None) -> "Job":
        """Create a job for the given checkpoint (reference job.py:94-144): a
        training or evaluation job for a ``train`` or ``package`` checkpoint,
        a search job for a ``search`` one."""
        from kge_tpu_torch.models import KgeModel

        config = Config.create_from(checkpoint)
        if new_config:
            config.load_config(new_config)
        dataset = Dataset.create_from(checkpoint, config, dataset)

        model = None
        if checkpoint["type"] in ("train", "package"):
            # the new config (e.g. --job.device) decides the model's device
            model = KgeModel.create_from(
                checkpoint, dataset=dataset, use_tmp_log_folder=False,
                new_config=new_config,
            )
            dataset = model.dataset
        job = Job.create(config, dataset, parent_job, model)
        job._load(checkpoint)
        job.config.log("Loaded checkpoint from {}...".format(checkpoint.get("file")))
        return job

    def _load(self, checkpoint: Dict):
        """Restore job state from a checkpoint (subclasses extend)."""

    # -- lifecycle -------------------------------------------------------------

    def run(self):
        if not self._is_prepared:
            self._prepare()
            self._is_prepared = True
        for f in self.pre_run_hooks:
            f(self)
        result = self._run()
        for f in self.post_run_hooks:
            f(self, result)
        return result

    def _prepare(self):
        pass

    def _run(self):
        raise NotImplementedError

    def trace(self, **kwargs) -> Dict[str, Any]:
        """Write a trace entry with this job's id and type."""
        job_type = self.config.get("job.type")
        return self.config.trace(
            job_id=self.job_id, job=job_type,
            **({"parent_job_id": self.parent_job.job_id[0:8]}
               if self.parent_job is not None else {}),
            **({"resumed_from_job_id": self.resumed_from_job_id[0:8]}
               if self.resumed_from_job_id else {}),
            **kwargs,
        )


class TrainingOrEvaluationJob(Job):
    """Adds batch/epoch hooks and the mutable ``current_trace`` dict
    (reference job.py:185-203)."""

    def __init__(self, config: Config, dataset: Dataset,
                 parent_job: Optional[Job] = None, model=None):
        super().__init__(config, dataset, parent_job, model)

        #: trace entries of the current epoch/batch being built up; hooks may
        #: add or modify entries
        self.current_trace: Dict[str, Optional[Dict]] = {
            "batch": None, "epoch": None
        }
        self.pre_batch_hooks: List[Callable[["Job"], Any]] = []
        self.post_batch_hooks: List[Callable[["Job"], Any]] = []
        self.pre_epoch_hooks: List[Callable[["Job"], Any]] = []
        self.post_epoch_hooks: List[Callable[["Job"], Any]] = []
