"""Jobs. Ported so far: negative-sampling training with shared negatives and
filtered entity-ranking evaluation (see ROADMAP.md for the other training
strategies and search)."""

from kge_tpu_torch.job.job import Job, TrainingOrEvaluationJob
from kge_tpu_torch.job.train import TrainingJob
from kge_tpu_torch.job.train_negative_sampling import TrainingJobNegativeSampling
from kge_tpu_torch.job.eval import EvaluationJob
from kge_tpu_torch.job.eval_entity_ranking import EntityRankingJob

__all__ = [
    "Job",
    "TrainingOrEvaluationJob",
    "TrainingJob",
    "TrainingJobNegativeSampling",
    "EvaluationJob",
    "EntityRankingJob",
]
