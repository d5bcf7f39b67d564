"""Model zoo: scorers, embedders, and the model factory.

Every model of kge_tpu is ported: the factorization family (DistMult,
ComplEx, RESCAL, CP, SimplE, RelationalTucker3), TransE, TransH, RotatE,
the neural models ConvE and Transformer, and the reciprocal relations
model, over lookup and projection embedders.
"""

from kge_tpu_torch.models.base import (
    KgeBase,
    KgeEmbedder,
    KgeModel,
    LookupEmbedder,
    ProjectionEmbedder,
    RelationalScorer,
    Tucker3RelationEmbedder,
)
from kge_tpu_torch.models.convert import (
    load_jax_opt_state,
    load_jax_params,
    param_leaves,
    to_jax_opt_state,
    to_jax_params,
)
from kge_tpu_torch.models.factorization import (
    CP,
    ComplEx,
    ComplExScorer,
    CPScorer,
    DistMult,
    DistMultScorer,
    RelationalTucker3,
    Rescal,
    RescalScorer,
    SimplE,
    SimplEScorer,
)
from kge_tpu_torch.models.neural import (
    ConvE,
    ConvEScorer,
    Transformer,
    TransformerScorer,
)
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
    "ProjectionEmbedder",
    "Tucker3RelationEmbedder",
    "RelationalScorer",
    "DistMult",
    "DistMultScorer",
    "ComplEx",
    "ComplExScorer",
    "Rescal",
    "RescalScorer",
    "CP",
    "CPScorer",
    "SimplE",
    "SimplEScorer",
    "RelationalTucker3",
    "ConvE",
    "ConvEScorer",
    "Transformer",
    "TransformerScorer",
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
