"""kge_tpu_torch: the PyTorch and CUDA port of kge_tpu.

A second package beside the JAX one, with its layout and module names. It
runs filtered entity-ranking evaluation (``python -m kge_tpu_torch
valid|test <folder>``) of models and checkpoints written by kge_tpu, on an
NVIDIA Hopper card, with the TPU's rank kernel rewritten in CUDA C++
(``ops/rank_kernel.py``, ``csrc/rank_counts.cu``). It imports neither jax
nor kge_tpu.
"""

from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset

__version__ = "0.1.0"

__all__ = ["Config", "Configurable", "Dataset"]
