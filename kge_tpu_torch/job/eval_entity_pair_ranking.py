"""Entity-pair ranking evaluation (reference
kge/job/eval_entity_pair_ranking.py:4-12; kge_tpu/job/
eval_entity_pair_ranking.py).

As in the reference and kge_tpu, this job is a declared placeholder: the
constructor wires it into the job registry so that configurations naming it
resolve, and it provides no ``_evaluate``.
"""

from __future__ import annotations

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.job.eval import EvaluationJob
from kge_tpu_torch.job.job import Job


class EntityPairRankingJob(EvaluationJob):
    """Ranks (subject, object) pairs for a given relation."""

    def __init__(self, config: Config, dataset: Dataset, parent_job, model):
        super().__init__(config, dataset, parent_job, model)
        if self.__class__ == EntityPairRankingJob:
            for f in Job.job_created_hooks:
                f(self)
