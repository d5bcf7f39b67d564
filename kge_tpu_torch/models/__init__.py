"""Model zoo: scorers, embedders, and the model factory.

Ported so far: ComplEx, TransE, TransH, RotatE and the reciprocal relations
model over lookup embedders. The other models of kge_tpu are listed in
ROADMAP.md.
"""

from kge_tpu_torch.models.base import (
    KgeBase,
    KgeEmbedder,
    KgeModel,
    LookupEmbedder,
    RelationalScorer,
)
from kge_tpu_torch.models.convert import (
    load_jax_opt_state,
    load_jax_params,
    param_leaves,
    to_jax_opt_state,
    to_jax_params,
)
from kge_tpu_torch.models.factorization import ComplEx, ComplExScorer
from kge_tpu_torch.models.reciprocal import ReciprocalRelationsModel
from kge_tpu_torch.models.translation import (
    RotatE,
    RotatEScorer,
    TransE,
    TransEScorer,
    TransH,
    TransHScorer,
)

__all__ = [
    "KgeBase",
    "KgeEmbedder",
    "KgeModel",
    "LookupEmbedder",
    "RelationalScorer",
    "ComplEx",
    "ComplExScorer",
    "ReciprocalRelationsModel",
    "TransE",
    "TransEScorer",
    "TransH",
    "TransHScorer",
    "RotatE",
    "RotatEScorer",
    "load_jax_params",
    "to_jax_params",
    "load_jax_opt_state",
    "to_jax_opt_state",
    "param_leaves",
]
