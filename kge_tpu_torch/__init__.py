"""kge_tpu_torch: the PyTorch and CUDA port of kge_tpu.

A second package beside the JAX one, with its layout and module names, for
one NVIDIA Hopper card. It reads and writes kge_tpu's folders, configs,
checkpoints and trace records, and runs

- training (``python -m kge_tpu_torch start|create|resume``) by KvsAll,
  1vsAll and negative sampling (every implementation of kge_tpu: shared,
  pooled or per-row negatives, scored against a batch's samples or the
  whole vocabulary, on the dense step, the fused dense step and the
  row-sparse step), in subbatches where asked, of the factorization family
  (DistMult, ComplEx, RESCAL, CP, SimplE, RelationalTucker3), the
  reciprocal relations model, TransE, TransH and RotatE, with any of
  kge_tpu's losses and optimizer rules;
- filtered entity-ranking evaluation (``eval|valid|test``) of every ported
  model;
- data preparation on the host: raw splits turned into ``.del`` files
  (``data/preprocess.py``, and ``dataset.from_dir`` in place), published
  datasets fetched (``data/download.py``), and the ``.del`` parser and the
  filtered-negative resampler in a C++ library built with ``g++`` on first
  use (``native/``), each with a numpy version.

Every kernel that kge_tpu writes in Pallas for the TPU is rewritten by hand
in CUDA C++ under ``csrc/`` and bound in ``ops/``: the rank kernel
(``ops/rank_kernel.py``), the lookup-gradient scatter and the row write
(``ops/embedding_ops.py``), the fused row-sparse optimizer update
(``ops/optim.py``) and the pooled distance scores with their backward
(``ops/dist_pool.py``). Each has a plain PyTorch version beside it, which
tensors on the CPU take. The package imports neither jax nor kge_tpu.
"""

from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset

__version__ = "0.1.0"

__all__ = ["Config", "Configurable", "Dataset"]
