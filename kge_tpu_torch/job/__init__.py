"""Jobs: training by negative sampling, 1vsAll and KvsAll, and filtered
entity-ranking evaluation (see ROADMAP.md for the training-loss and
entity-pair evaluations and search)."""

from kge_tpu_torch.job.job import Job, TrainingOrEvaluationJob
from kge_tpu_torch.job.train import TrainingJob
from kge_tpu_torch.job.train_1vsAll import TrainingJob1vsAll
from kge_tpu_torch.job.train_KvsAll import TrainingJobKvsAll
from kge_tpu_torch.job.train_negative_sampling import TrainingJobNegativeSampling
from kge_tpu_torch.job.eval import EvaluationJob
from kge_tpu_torch.job.eval_entity_ranking import EntityRankingJob

__all__ = [
    "Job",
    "TrainingOrEvaluationJob",
    "TrainingJob",
    "TrainingJob1vsAll",
    "TrainingJobKvsAll",
    "TrainingJobNegativeSampling",
    "EvaluationJob",
    "EntityRankingJob",
]
