"""Jobs: training by negative sampling, 1vsAll and KvsAll, filtered
entity-ranking evaluation, the training-loss evaluation, kge_tpu's
entity-pair placeholder, and hyperparameter search (manual, grid, Ax-style
and GraSH)."""

from kge_tpu_torch.job.job import Job, TrainingOrEvaluationJob
from kge_tpu_torch.job.train import TrainingJob
from kge_tpu_torch.job.train_1vsAll import TrainingJob1vsAll
from kge_tpu_torch.job.train_KvsAll import TrainingJobKvsAll
from kge_tpu_torch.job.train_negative_sampling import TrainingJobNegativeSampling
from kge_tpu_torch.job.eval import EvaluationJob
from kge_tpu_torch.job.eval_entity_ranking import EntityRankingJob
from kge_tpu_torch.job.eval_entity_pair_ranking import EntityPairRankingJob
from kge_tpu_torch.job.eval_training_loss import TrainingLossEvaluationJob
from kge_tpu_torch.job.search_grash import GraSHSearchJob
from kge_tpu_torch.job.search import (
    AutoSearchJob,
    AxSearchJob,
    GridSearchJob,
    ManualSearchJob,
    SearchJob,
)

__all__ = [
    "Job",
    "TrainingOrEvaluationJob",
    "TrainingJob",
    "TrainingJob1vsAll",
    "TrainingJobKvsAll",
    "TrainingJobNegativeSampling",
    "EvaluationJob",
    "EntityRankingJob",
    "EntityPairRankingJob",
    "TrainingLossEvaluationJob",
    "SearchJob",
    "ManualSearchJob",
    "GridSearchJob",
    "AutoSearchJob",
    "AxSearchJob",
    "GraSHSearchJob",
]
