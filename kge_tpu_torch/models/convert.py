"""Weights across the two packages.

kge_tpu keeps a model's parameters as a pytree of arrays,
``{"entity_embedder": <tree>, "relation_embedder": <tree>}``, where a
lookup embedder's tree is ``{"embeddings": [vocab, d]}`` (2R rows for the
reciprocal relations model, 2d columns for TransH's [translation | normal])
and a projection embedder's ``{"base": <base tree>, "projection": [d_out,
d_in]}`` (RelationalTucker3's relation embedder); plus ``"scorer"`` for
scorers with parameters of their own. Its checkpoints store the tree with
numpy leaves. This package keeps them in its modules, and each embedder
gives its tree with tensor leaves (``param_tree``). ``load_jax_params``
copies such a tree into a model, ``to_jax_params`` reads one out, both
through numpy.

kge_tpu's optimizer state is ``{"leaves": [state dict per parameter leaf],
"step": int}`` with the leaves in its tree-flatten order (keys sorted at
every level: ``entity_embedder.embeddings``, then
``relation_embedder.base.embeddings`` and ``relation_embedder.projection``
or ``relation_embedder.embeddings``). ``param_leaves`` lists a model's
parameters in that order, and ``load_jax_opt_state`` / ``to_jax_opt_state``
carry the state across, again through numpy.
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


def _flatten(tree, path=()) -> List[Tuple[Tuple[str, ...], Any]]:
    """(path, leaf) pairs of a nested dict, keys sorted at every level."""
    if not isinstance(tree, dict):
        return [(path, tree)]
    return [leaf for key in sorted(tree) for leaf in _flatten(tree[key], path + (key,))]


def _model_tree(model) -> Dict[str, Any]:
    return {key: embedder.param_tree() for key, embedder in _embedders(model).items()}


@torch.no_grad()
def load_jax_params(model, tree: Dict[str, Any]) -> None:
    """Copy kge_tpu's parameter tree (numpy or array-like leaves) into
    ``model``'s parameters, on the device they already live on."""
    extra = set(tree) - set(_EMBEDDERS)
    if extra:
        raise ValueError(
            f"parameters {sorted(extra)} have no counterpart in "
            f"{type(model).__name__} (only embedder parameters are ported)"
        )
    own = _flatten(_model_tree(model))
    given = _flatten(tree)
    if [path for path, _ in given] != [path for path, _ in own]:
        raise ValueError(
            f"parameters {['.'.join(p) for p, _ in given]} do not match "
            f"{type(model).__name__}'s {['.'.join(p) for p, _ in own]}"
        )
    for (path, param), (_, leaf) in zip(own, given):
        value = np.asarray(leaf, dtype=np.float32)
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(
                f"{'.'.join(path)} has shape {value.shape}, the model "
                f"expects {tuple(param.shape)}"
            )
        param.copy_(torch.tensor(value))


@torch.no_grad()
def to_jax_params(model) -> Dict[str, Any]:
    """``model``'s parameters as kge_tpu's tree of numpy arrays."""

    def to_numpy(tree):
        if isinstance(tree, dict):
            return {key: to_numpy(value) for key, value in tree.items()}
        return tree.detach().cpu().numpy().copy()

    return to_numpy(_model_tree(model))


def param_leaves(model) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """``model``'s parameters as (path in kge_tpu's tree, tensor) pairs in
    kge_tpu's tree-flatten order (keys sorted at every level)."""
    return _flatten(_model_tree(model))


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
