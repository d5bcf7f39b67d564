"""Jobs. Ported so far: filtered entity-ranking evaluation (see ROADMAP.md
for training and search)."""

from kge_tpu_torch.job.job import Job, TrainingOrEvaluationJob
from kge_tpu_torch.job.eval import EvaluationJob
from kge_tpu_torch.job.eval_entity_ranking import EntityRankingJob

__all__ = [
    "Job",
    "TrainingOrEvaluationJob",
    "EvaluationJob",
    "EntityRankingJob",
]
