"""Weights across the two packages.

kge_tpu keeps a model's parameters as a pytree of arrays,
``{"entity_embedder": <tree>, "relation_embedder": <tree>}``, where a
lookup embedder's tree is ``{"embeddings": [vocab, d]}`` (2R rows for the
reciprocal relations model, 2d columns for TransH's [translation | normal])
and a projection embedder's ``{"base": <base tree>, "projection": [d_out,
d_in]}`` (RelationalTucker3's relation embedder); plus ``"scorer"`` for
scorers with parameters of their own: ConvE's convolution, projection and
batch-norm statistics, the Transformer's tokens and its ``layers``, a list
of one dict per encoder layer. Its checkpoints store the tree with numpy
leaves. This package keeps them in its modules, and each embedder and
scorer gives its tree with tensor leaves (``param_tree``; a scorer without
parameters gives an empty one, and the model's tree then has no
``"scorer"``). ``load_jax_params`` copies such a tree into a model,
``to_jax_params`` reads one out, both through numpy. Leaves keep their
dtype, float32, bfloat16 or float16 (kge_tpu's dtype policy; other leaves
become float32). float16 is numpy's own ``float16``. numpy has no bfloat16 without the ``ml_dtypes`` package,
which this package does not use, so a bfloat16 leaf is read from kge_tpu's
``ml_dtypes`` array through its 2-byte buffer and given out as a CPU
``torch.bfloat16`` tensor; ``utils/io.py`` pickles such tensors as the
arrays kge_tpu reads.

kge_tpu's optimizer state is ``{"leaves": [state dict per parameter leaf],
"step": int}`` with the leaves in its tree-flatten order: keys sorted at
every level, list items in their order (``entity_embedder.embeddings``,
then ``relation_embedder.base.embeddings`` and
``relation_embedder.projection`` or ``relation_embedder.embeddings``, then
``scorer.cls``, ``scorer.layers.0.in_proj_b``, ...). The batch-norm
statistics are leaves of that tree too, so the optimizer holds a state for
each (which their zero gradient leaves at zero under Adam without weight
decay); the training step overwrites them after the update. ``param_leaves``
lists a model's parameters in that order, and ``load_jax_opt_state`` /
``to_jax_opt_state`` carry the state across, again through numpy.

Under a model axis (parallel/mesh.py) a model holds the rows ``[lo, hi)``
of its entity table (``leaf_row_ranges``): a whole leaf or state read from
a checkpoint keeps those rows, and ``to_jax_params`` gives the shard, which
utils/io.py writes in kge_tpu's sharded schema.
"""

from __future__ import annotations

from typing import Any, Dict, List, Tuple

import numpy as np
import torch


def _flatten(tree, path=()) -> List[Tuple[Tuple[Any, ...], Any]]:
    """(path, leaf) pairs of nested dicts and lists in
    ``jax.tree_util``'s flatten order: dict keys sorted, list items in
    order (a list item's path element is its index)."""
    if isinstance(tree, dict):
        return [leaf for key in sorted(tree)
                for leaf in _flatten(tree[key], path + (key,))]
    if isinstance(tree, (list, tuple)):
        return [leaf for i, item in enumerate(tree)
                for leaf in _flatten(item, path + (i,))]
    return [(path, tree)]


def _model_tree(model) -> Dict[str, Any]:
    tree = {
        "entity_embedder": model.get_s_embedder().param_tree(),
        "relation_embedder": model.get_p_embedder().param_tree(),
    }
    scorer = model.get_scorer().param_tree()
    if scorer:
        tree["scorer"] = scorer
    return tree


def _name(path) -> str:
    return ".".join(str(key) for key in path)


def leaf_row_ranges(model) -> Dict[Tuple[Any, ...], Tuple[int, int, int]]:
    """{path: (lo, hi, rows)} of the leaves that hold the rows [lo, hi) of
    a table of ``rows`` rows (the entity table under a model axis)."""
    embedder = model.get_s_embedder()
    shard = getattr(embedder, "row_range", None)
    if shard is None:
        return {}
    return {("entity_embedder", "embeddings"):
            (shard[0], shard[1], embedder.vocab_size)}


def _own_rows(value: torch.Tensor, rows) -> torch.Tensor:
    """A whole leaf cut to a shard's rows ``(lo, hi, total)`` (None: as
    it is); a leaf of the shard's size is taken as the shard."""
    if rows is None:
        return value
    lo, hi, total = rows
    if value.shape[0] == total and total != hi - lo:
        return value[lo:hi]
    return value


def leaf_tensor(value) -> torch.Tensor:
    """A checkpoint leaf (numpy or array-like, a bfloat16 ``ml_dtypes``
    array, or a tensor) as a CPU tensor: bfloat16 and float16 stay as they
    are, any other float becomes float32."""
    if isinstance(value, torch.Tensor):
        tensor = value.detach().cpu()
    else:
        array = np.asarray(value)
        if array.dtype.name == "bfloat16":  # ml_dtypes' type, read by bits
            tensor = torch.from_numpy(
                np.ascontiguousarray(array).view(np.uint16).astype(np.int16)
            ).view(torch.bfloat16)
        elif array.dtype == np.float16:
            tensor = torch.from_numpy(np.array(array, dtype=np.float16))
        else:
            tensor = torch.from_numpy(np.array(array, dtype=np.float32))
    if tensor.dtype not in (torch.float32, torch.bfloat16, torch.float16):
        tensor = tensor.float()
    return tensor


def _numpy_leaf(tensor: torch.Tensor):
    """A leaf for a checkpoint: a numpy array, or a CPU bfloat16 tensor
    (numpy has no bfloat16 here)."""
    tensor = tensor.detach().cpu()
    if tensor.dtype == torch.bfloat16:
        return tensor.clone()
    return tensor.numpy().copy()


@torch.no_grad()
def load_jax_params(model, tree: Dict[str, Any]) -> None:
    """Copy kge_tpu's parameter tree (numpy or array-like leaves) into
    ``model``'s parameters and statistics, on the device they already live
    on."""
    own = _flatten(_model_tree(model))
    given = _flatten(tree)
    shards = leaf_row_ranges(model)
    if [path for path, _ in given] != [path for path, _ in own]:
        raise ValueError(
            f"parameters {[_name(p) for p, _ in given]} do not match "
            f"{type(model).__name__}'s {[_name(p) for p, _ in own]}"
        )
    for (path, param), (_, leaf) in zip(own, given):
        value = _own_rows(leaf_tensor(leaf), shards.get(path))
        if tuple(value.shape) != tuple(param.shape):
            raise ValueError(
                f"{_name(path)} has shape {tuple(value.shape)}, the model "
                f"expects {tuple(param.shape)}"
            )
        if value.dtype == param.dtype:
            param.copy_(value)
        else:  # the leaf's dtype wins, as in kge_tpu
            param.data = value.to(param.device)


@torch.no_grad()
def to_jax_params(model) -> Dict[str, Any]:
    """``model``'s parameters as kge_tpu's tree of numpy arrays."""

    def to_numpy(tree):
        if isinstance(tree, dict):
            return {key: to_numpy(value) for key, value in tree.items()}
        if isinstance(tree, list):
            return [to_numpy(value) for value in tree]
        return _numpy_leaf(tree)

    return to_numpy(_model_tree(model))


def param_leaves(model) -> List[Tuple[Tuple[str, ...], torch.Tensor]]:
    """``model``'s parameters and statistics as (path in kge_tpu's tree,
    tensor) pairs in kge_tpu's tree-flatten order."""
    return _flatten(_model_tree(model))


def load_jax_opt_state(state: Dict[str, Any], leaves,
                       row_ranges=None) -> Dict[str, Any]:
    """kge_tpu's optimizer state (numpy or array-like leaves) as this
    package's: tensors on the device of the parameter each belongs to; the
    state of a row shard (``row_ranges``, of ``leaf_row_ranges``) keeps its
    rows."""
    row_ranges = row_ranges or {}
    if len(state["leaves"]) != len(leaves):
        raise ValueError(
            f"optimizer state has {len(state['leaves'])} leaves, the model "
            f"has {len(leaves)} parameters"
        )
    out = []
    for leaf_state, (path, param) in zip(state["leaves"], leaves):
        converted = {}
        for name, value in leaf_state.items():
            value = _own_rows(leaf_tensor(value), row_ranges.get(path))
            if tuple(value.shape) != tuple(param.shape):
                raise ValueError(
                    f"optimizer state {_name(path)}.{name} has shape "
                    f"{tuple(value.shape)}, the parameter {tuple(param.shape)}"
                )
            converted[name] = value.to(param.device, copy=True)
        out.append(converted)
    return {"leaves": out, "step": int(np.asarray(state["step"]))}


def to_jax_opt_state(state: Dict[str, Any]) -> Dict[str, Any]:
    """This package's optimizer state as kge_tpu's tree of numpy arrays."""
    return {
        "leaves": [
            {name: _numpy_leaf(value) for name, value in leaf_state.items()}
            for leaf_state in state["leaves"]
        ],
        "step": np.asarray(int(state["step"]), dtype=np.int32),
    }
