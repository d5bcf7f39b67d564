"""Weights across the two packages.

kge_tpu keeps a model's parameters as a pytree of arrays,
``{"entity_embedder": {"embeddings": [E, d]}, "relation_embedder":
{"embeddings": [R or 2R, d or 2d]}}`` (2R rows for the reciprocal
relations model, 2d columns for TransH's [translation | normal]; plus
``"scorer"`` for scorers with parameters of their own); its checkpoints
store the tree with numpy leaves.
This package keeps them in its modules. ``load_jax_params`` copies such a
tree into a model, ``to_jax_params`` reads one out, both through numpy.

kge_tpu's optimizer state is ``{"leaves": [state dict per parameter leaf],
"step": int}`` with the leaves in its tree-flatten order (sorted keys:
``entity_embedder.embeddings``, ``relation_embedder.embeddings``).
``param_leaves`` lists a model's parameters in that order, and
``load_jax_opt_state`` / ``to_jax_opt_state`` carry the state across, again
through numpy.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch

_EMBEDDERS = {
    "entity_embedder": "get_s_embedder",
    "relation_embedder": "get_p_embedder",
}


def _embedders(model):
    return {key: getattr(model, getter)() for key, getter in _EMBEDDERS.items()}


@torch.no_grad()
def load_jax_params(model, tree: Dict[str, Any]) -> None:
    """Copy kge_tpu's parameter tree (numpy or array-like leaves) into
    ``model``'s parameters, on the device they already live on."""
    extra = set(tree) - set(_EMBEDDERS)
    if extra:
        raise ValueError(
            f"parameters {sorted(extra)} have no counterpart in "
            f"{type(model).__name__} (only lookup embedders are ported)"
        )
    for key, embedder in _embedders(model).items():
        leaves = tree[key]
        if set(leaves) != {"embeddings"}:
            raise ValueError(
                f"{key}: expected a lookup embedder's {{'embeddings'}}, "
                f"got {sorted(leaves)}"
            )
        value = np.asarray(leaves["embeddings"], dtype=np.float32)
        if tuple(value.shape) != tuple(embedder.embeddings.shape):
            raise ValueError(
                f"{key}.embeddings has shape {value.shape}, the model "
                f"expects {tuple(embedder.embeddings.shape)}"
            )
        embedder.embeddings.copy_(torch.tensor(value))


@torch.no_grad()
def to_jax_params(model) -> Dict[str, Any]:
    """``model``'s parameters as kge_tpu's tree of numpy arrays."""
    return {
        key: {"embeddings": embedder.embeddings.detach().cpu().numpy().copy()}
        for key, embedder in _embedders(model).items()
    }


def param_leaves(model) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """``model``'s parameters as (path in kge_tpu's tree, tensor) pairs in
    kge_tpu's tree-flatten order (keys sorted at every level)."""
    return [
        ((key, "embeddings"), embedder.embeddings)
        for key, embedder in sorted(_embedders(model).items())
    ]


def load_jax_opt_state(state: Dict[str, Any], leaves) -> Dict[str, Any]:
    """kge_tpu's optimizer state (numpy or array-like leaves) as this
    package's: tensors on the device of the parameter each belongs to."""
    if len(state["leaves"]) != len(leaves):
        raise ValueError(
            f"optimizer state has {len(state['leaves'])} leaves, the model "
            f"has {len(leaves)} parameters"
        )
    out = []
    for leaf_state, (path, param) in zip(state["leaves"], leaves):
        converted = {}
        for name, value in leaf_state.items():
            value = np.asarray(value, dtype=np.float32)
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"optimizer state {'.'.join(path)}.{name} has shape "
                    f"{value.shape}, the parameter {tuple(param.shape)}"
                )
            converted[name] = torch.tensor(value, device=param.device)
        out.append(converted)
    return {"leaves": out, "step": int(np.asarray(state["step"]))}


def to_jax_opt_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """This package's optimizer state as kge_tpu's tree of numpy arrays."""
    return {
        "leaves": [
            {name: value.detach().cpu().numpy().copy()
             for name, value in leaf_state.items()}
            for leaf_state in state["leaves"]
        ],
        "step": np.asarray(int(state["step"]), dtype=np.int32),
    }
