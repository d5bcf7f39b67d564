"""The dtype policy: ``parallel.param_dtype`` and ``parallel.compute_dtype``.

kge_tpu stores embedding tables in ``param_dtype`` and casts embeddings to
``compute_dtype`` before scoring (kge_tpu/models/base.py ``KgeEmbedder``);
everything else follows JAX's type promotion, which differs from torch's in
two places that matter in bfloat16 and float16:

- a Python scalar is *weakly typed* in JAX: ``0.9 * x`` rounds 0.9 to x's
  dtype first and computes in that dtype. torch keeps the scalar in float32
  (its "opmath" type) and rounds only the result, so in bfloat16 the two
  differ in about a third of the entries. ``weak(0.9, x)`` gives torch the
  scalar JAX would use. In float16 a small constant may round to a
  subnormal or to 0 (Adagrad's eps 1e-10, Adam's 1e-8, the L2 epilogue's
  1e-30 all become 0), and JAX computes with that 0.
- a float32 *array* promotes a bfloat16 or float16 array to float32 in JAX,
  even with zero dimensions (the optimizer's learning rate); a 0-dim
  float32 tensor leaves a bfloat16 or float16 tensor as it is in torch.
  ``strong32(x)`` is x promoted as JAX promotes it against such an array.
  bfloat16 against float16 is float32 in both.

Both are the identity for float32 tensors, so the float32 path computes
what it computed before the policy existed.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch

#: the dtypes both settings take, by their config names
DTYPES = {"float32": torch.float32, "bfloat16": torch.bfloat16,
          "float16": torch.float16}
#: the dtypes narrower than float32, which promote to it
NARROW = (torch.bfloat16, torch.float16)


def torch_dtype(config, key: str) -> torch.dtype:
    """The torch dtype named by ``key`` (``parallel.param_dtype`` or
    ``parallel.compute_dtype``); raises for the names this package does
    not run (kge_tpu would run any ``jnp.dtype``)."""
    name = str(config.get(key))
    if name not in DTYPES:
        raise ValueError(
            f"{key}={name}: kge_tpu_torch runs float32, bfloat16 and float16; "
            "other dtypes are not ported"
        )
    return DTYPES[name]


@functools.lru_cache(maxsize=256)
def _scalar(value: float, dtype: torch.dtype) -> torch.Tensor:
    return torch.tensor(value, dtype=dtype)


def weak(value: float, like: torch.Tensor):
    """The Python scalar ``value`` as JAX applies it to ``like``: rounded to
    ``like``'s dtype when that is narrower than float32 (a 0-dim CPU tensor,
    which torch takes as a scalar on any device), else ``value`` itself."""
    if like.dtype in (torch.float32, torch.float64):
        return value
    return _scalar(float(value), like.dtype)


def strong32(x: torch.Tensor) -> torch.Tensor:
    """``x`` promoted against a float32 array, as JAX promotes it: bfloat16
    and float16 become float32 (exactly), float32 stays."""
    return x.float() if x.dtype in NARROW else x


def promote(*tensors, dtype: Optional[torch.dtype] = None):
    """The tensors (None passes) cast to their common dtype under
    promotion, with ``dtype`` (if given) taking part: what JAX computes
    when it mixes them in one operation."""
    common = dtype
    for t in tensors:
        if t is not None:
            common = t.dtype if common is None else torch.promote_types(
                common, t.dtype)
    return tuple(t if t is None or t.dtype == common else t.to(common)
                 for t in tensors)
