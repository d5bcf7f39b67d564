"""Jobs: training by negative sampling, 1vsAll and KvsAll, filtered
entity-ranking evaluation, the training-loss evaluation and kge_tpu's
entity-pair placeholder (see ROADMAP.md for search)."""

from kge_tpu_torch.job.job import Job, TrainingOrEvaluationJob
from kge_tpu_torch.job.train import TrainingJob
from kge_tpu_torch.job.train_1vsAll import TrainingJob1vsAll
from kge_tpu_torch.job.train_KvsAll import TrainingJobKvsAll
from kge_tpu_torch.job.train_negative_sampling import TrainingJobNegativeSampling
from kge_tpu_torch.job.eval import EvaluationJob
from kge_tpu_torch.job.eval_entity_ranking import EntityRankingJob
from kge_tpu_torch.job.eval_entity_pair_ranking import EntityPairRankingJob
from kge_tpu_torch.job.eval_training_loss import TrainingLossEvaluationJob

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
]
