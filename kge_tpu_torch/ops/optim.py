"""Optimizers and learning-rate schedulers.

The port of kge_tpu/ops/optim.py: Adagrad, Adam, AdamW, SGD, RMSprop,
Adadelta and Adamax with torch.optim semantics, regex-defined parameter
groups with per-group hyperparameters, and the lr_scheduler family driven
from the epoch loop. The rules are kge_tpu's formulas written as
elementwise torch functions (not ``torch.optim``): kge_tpu's rules are the
specification, term for term, so that a step taken by either package from
the same state gives the same tables.

Where kge_tpu's optimizer is a pure function over a parameter pytree, this
one updates in place under ``torch.no_grad()``: it holds the model's
parameter tensors in kge_tpu's tree-flatten order (sorted keys:
``entity_embedder.embeddings``, ``relation_embedder.embeddings``), and its
state is ``{"leaves": [state dict per leaf], "step": int}`` in the same
order, which is also the checkpoint's ``optimizer_state``.

``fused_sorted_update`` replaces kge_tpu's Pallas kernel of that name
(ops/pallas_ops.py): one pass over a table that applies any rule with dense
semantics from row gradients. Beside it stand its plain PyTorch version
(``fused_sorted_update_plain``: the path for CPU tensors and the kernel's
oracle on the card) and a launch counter (``.launches``).
"""

from __future__ import annotations

import math
import re
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from kge_tpu_torch.config import Config

#: a parameter leaf: its path in kge_tpu's parameter tree, and the tensor
Leaf = Tuple[Tuple[str, ...], torch.Tensor]


# -- torch-style parameter naming ---------------------------------------------

_KEY_RENAMES = {
    "entity_embedder": "_entity_embedder",
    "relation_embedder": "_relation_embedder",
    "base_model": "_base_model",
    "scorer": "_scorer",
    "base": "_base_embedder",
}


def parameter_name(path: Sequence[str]) -> str:
    """Dotted name of a parameter-tree path as the reference names it, so
    that regex parameter groups written for the reference keep matching
    (e.g. ``.*_relation_embedder.*``)."""
    parts: List[str] = []
    for key in path:
        key = str(key)
        if key == "embeddings":
            parts.append("_embeddings.weight")
        elif key == "projection":
            parts.append("_projection.weight")
        else:
            parts.append(_KEY_RENAMES.get(key, key))
    return ".".join(parts)


# -- per-leaf optimizer rules --------------------------------------------------

# every rule: init(param, args) -> state dict of tensors;
#             update(grad, state, param, lr, step, args) -> (delta, new_state)
# `delta` is the value to *add* to the parameter; `lr` is a float and `step`
# an int (kge_tpu traces both).


def _pow_const(base: float, t: int) -> float:
    """base ** t as exp(t ln b) in float32, as kge_tpu computes it."""
    return float(np.exp(np.float32(t) * np.float32(math.log(base))))


def _one_minus_pow(base: float, t: int) -> float:
    return float(np.float32(1.0) - np.float32(_pow_const(base, t)))


def _wd(grad, param, args):
    wd = args.get("weight_decay", 0.0)
    if wd:
        return grad + wd * param
    return grad


def _adagrad_init(param, args):
    iv = args.get("initial_accumulator_value", 0.0)
    return {"sum": torch.full_like(param, iv)}


def _adagrad_update(grad, state, param, lr, step, args):
    eps = args.get("eps", 1e-10)
    lr_decay = args.get("lr_decay", 0.0)
    grad = _wd(grad, param, args)
    clr = _decayed_lr(lr, step, lr_decay)
    new_sum = state["sum"] + grad * grad
    delta = -clr * grad / (torch.sqrt(new_sum) + eps)
    return delta, {"sum": new_sum}


def _decayed_lr(lr: float, step: int, lr_decay: float) -> float:
    return float(np.float32(lr) / np.float32(1 + step * lr_decay))


def _adam_init(param, args):
    return {"m": torch.zeros_like(param), "v": torch.zeros_like(param)}


def _adam_update(grad, state, param, lr, step, args, decoupled=False):
    b1, b2 = args.get("betas", (0.9, 0.999))
    eps = args.get("eps", 1e-8)
    wd = args.get("weight_decay", 0.0)
    if not decoupled:
        grad = _wd(grad, param, args)
    m = b1 * state["m"] + (1 - b1) * grad
    v = b2 * state["v"] + (1 - b2) * grad * grad
    t = step + 1
    m_hat = m / _one_minus_pow(b1, t)
    v_hat = v / _one_minus_pow(b2, t)
    delta = -lr * m_hat / (torch.sqrt(v_hat) + eps)
    if decoupled and wd:
        delta = delta - lr * wd * param
    return delta, {"m": m, "v": v}


def _adamax_init(param, args):
    return {"m": torch.zeros_like(param), "u": torch.zeros_like(param)}


def _adamax_update(grad, state, param, lr, step, args):
    b1, b2 = args.get("betas", (0.9, 0.999))
    eps = args.get("eps", 1e-8)
    grad = _wd(grad, param, args)
    m = b1 * state["m"] + (1 - b1) * grad
    u = torch.maximum(b2 * state["u"], torch.abs(grad) + eps)
    t = step + 1
    scale = float(np.float32(-lr) / np.float32(_one_minus_pow(b1, t)))
    delta = scale * m / u
    return delta, {"m": m, "u": u}


def _sgd_init(param, args):
    if args.get("momentum", 0.0):
        return {"momentum": torch.zeros_like(param)}
    return {}


def _sgd_update(grad, state, param, lr, step, args):
    momentum = args.get("momentum", 0.0)
    dampening = args.get("dampening", 0.0)
    nesterov = args.get("nesterov", False)
    grad = _wd(grad, param, args)
    if momentum:
        if step == 0:
            buf = grad
        else:
            buf = momentum * state["momentum"] + (1 - dampening) * grad
        d = grad + momentum * buf if nesterov else buf
        return -lr * d, {"momentum": buf}
    return -lr * grad, {}


def _rmsprop_init(param, args):
    state = {"sq": torch.zeros_like(param)}
    if args.get("momentum", 0.0):
        state["momentum"] = torch.zeros_like(param)
    if args.get("centered", False):
        state["avg"] = torch.zeros_like(param)
    return state


def _rmsprop_update(grad, state, param, lr, step, args):
    alpha = args.get("alpha", 0.99)
    eps = args.get("eps", 1e-8)
    momentum = args.get("momentum", 0.0)
    centered = args.get("centered", False)
    grad = _wd(grad, param, args)
    sq = alpha * state["sq"] + (1 - alpha) * grad * grad
    new_state = {"sq": sq}
    if centered:
        avg = alpha * state["avg"] + (1 - alpha) * grad
        denom = torch.sqrt(sq - avg * avg + eps)
        new_state["avg"] = avg
    else:
        denom = torch.sqrt(sq) + eps
    if momentum:
        buf = momentum * state["momentum"] + grad / denom
        new_state["momentum"] = buf
        return -lr * buf, new_state
    return -lr * grad / denom, new_state


def _adadelta_init(param, args):
    return {"sq": torch.zeros_like(param), "acc": torch.zeros_like(param)}


def _adadelta_update(grad, state, param, lr, step, args):
    rho = args.get("rho", 0.9)
    eps = args.get("eps", 1e-6)
    grad = _wd(grad, param, args)
    sq = rho * state["sq"] + (1 - rho) * grad * grad
    delta = torch.sqrt(state["acc"] + eps) / torch.sqrt(sq + eps) * grad
    acc = rho * state["acc"] + (1 - rho) * delta * delta
    return -lr * delta, {"sq": sq, "acc": acc}


_RULES = {
    "adagrad": (_adagrad_init, _adagrad_update, 0.01),
    "adam": (_adam_init, lambda *a: _adam_update(*a, decoupled=False), 1e-3),
    "adamw": (_adam_init, lambda *a: _adam_update(*a, decoupled=True), 1e-3),
    "adamax": (_adamax_init, _adamax_update, 2e-3),
    "sgd": (_sgd_init, _sgd_update, None),  # torch SGD requires lr
    "rmsprop": (_rmsprop_init, _rmsprop_update, 1e-2),
    "adadelta": (_adadelta_init, _adadelta_update, 1.0),
}


# -- K4: one-pass dense-semantics update from row gradients --------------------

# rule numbers and flag bits of csrc/fused_row_update.cu
_KERNEL_RULE = {"adagrad": 0, "adam": 1, "adamw": 1, "adamax": 2, "sgd": 3,
                "rmsprop": 4, "adadelta": 5}
_FLAG_NESTEROV, _FLAG_FIRST_STEP, _FLAG_CENTERED, _FLAG_DECOUPLED = 1, 2, 4, 8


def _kernel_hyper(opt_type: str, args: Dict[str, Any], lr: float, step: int):
    """(the 12 float hyperparameters of the kernel's ``Hyper``, flags):
    every scalar that the rule's plain version computes on the host,
    computed the same way, so that both round alike."""
    h = dict.fromkeys(
        ("lr", "wd", "eps", "b1", "omb1", "b2", "omb2", "c1", "c2",
         "momentum", "omd", "lrwd"), 0.0)
    h["lr"] = lr
    h["wd"] = args.get("weight_decay", 0.0)
    flags = 0
    t = step + 1
    if opt_type == "adagrad":
        h["lr"] = _decayed_lr(lr, step, args.get("lr_decay", 0.0))
        h["eps"] = args.get("eps", 1e-10)
    elif opt_type in ("adam", "adamw", "adamax"):
        b1, b2 = args.get("betas", (0.9, 0.999))
        h.update(b1=b1, omb1=1 - b1, b2=b2, omb2=1 - b2,
                 eps=args.get("eps", 1e-8), c1=_one_minus_pow(b1, t),
                 c2=_one_minus_pow(b2, t), lrwd=lr * h["wd"])
        if opt_type == "adamw":
            flags |= _FLAG_DECOUPLED
        if opt_type == "adamax":
            h["c1"] = float(np.float32(-lr) / np.float32(h["c1"]))
    elif opt_type == "sgd":
        h["momentum"] = args.get("momentum", 0.0)
        h["omd"] = 1 - args.get("dampening", 0.0)
        if args.get("nesterov", False):
            flags |= _FLAG_NESTEROV
        if step == 0:
            flags |= _FLAG_FIRST_STEP
    elif opt_type == "rmsprop":
        alpha = args.get("alpha", 0.99)
        h.update(b1=alpha, omb1=1 - alpha, eps=args.get("eps", 1e-8),
                 momentum=args.get("momentum", 0.0))
        if args.get("centered", False):
            flags |= _FLAG_CENTERED
    elif opt_type == "adadelta":
        rho = args.get("rho", 0.9)
        h.update(b1=rho, omb1=1 - rho, eps=args.get("eps", 1e-6))
    else:
        raise ValueError(f"unsupported optimizer type: {opt_type}")
    return np.array(list(h.values()), dtype=np.float32), flags


def _check_fused(ids, upd, param, states):
    if ids.dim() != 1 or upd.dim() != 2 or param.dim() != 2 or upd.shape != (
        ids.shape[0], param.shape[1]
    ):
        raise ValueError(
            f"the fused update takes ids [n], upd [n, D] and param [R, D], "
            f"got {tuple(ids.shape)}, {tuple(upd.shape)}, {tuple(param.shape)}"
        )
    for name, value in states.items():
        if value.shape != param.shape:
            raise ValueError(
                f"state {name} has shape {tuple(value.shape)}, the parameter "
                f"{tuple(param.shape)}"
            )


@torch.no_grad()
def fused_sorted_update_plain(opt_type: str, args: Dict[str, Any],
                              ids: torch.Tensor, upd: torch.Tensor,
                              param: torch.Tensor,
                              states: Dict[str, torch.Tensor], lr: float,
                              step: int) -> Dict[str, torch.Tensor]:
    """Plain version of ``fused_sorted_update``: ``index_add_`` into a
    dense zero gradient, then the rule of ``_RULES`` over the whole table,
    written back into ``param`` and ``states``."""
    _check_fused(ids, upd, param, states)
    grad = torch.zeros_like(param).index_add_(0, ids.long(), upd.to(param.dtype))
    delta, new_states = _RULES[opt_type][1](grad, states, param, lr, step, args)
    param.add_(delta)
    for name, value in new_states.items():
        states[name].copy_(value)
    return states


@torch.no_grad()
def fused_sorted_update(opt_type: str, args: Dict[str, Any],
                        ids: torch.Tensor, upd: torch.Tensor,
                        param: torch.Tensor, states: Dict[str, torch.Tensor],
                        lr: float, step: int) -> Dict[str, torch.Tensor]:
    """One optimizer step of a whole table from row gradients, IN PLACE.

    Semantically ``g = zeros_like(param).index_add_(0, ids, upd)`` followed
    by the rule ``opt_type`` of ``_RULES`` on ``param`` and ``states`` with
    gradient ``g``: every row is updated, named by ``ids`` (duplicates,
    any order) or not, so Adam's moments decay and weight decay applies
    everywhere as on the dense step. The dense gradient is never held: the
    wrapper sorts the ids and sums duplicates with the scatter kernel into
    one gradient row per distinct id, and the kernel
    (``csrc/fused_row_update.cu``, which replaces kge_tpu's
    ``fused_sorted_update``) walks the table once. ``param`` and the
    tensors of ``states`` keep their storage; returns ``states``. On CPU
    tensors this is ``fused_sorted_update_plain``; a CUDA tensor goes to
    the kernel or the call raises. Ids outside the table are ignored on
    the card."""
    _check_fused(ids, upd, param, states)
    if param.device.type == "cpu":
        return fused_sorted_update_plain(
            opt_type, args, ids, upd, param, states, lr, step
        )
    if param.device.type != "cuda":
        raise ValueError(f"fused_sorted_update: unsupported device {param.device}")
    if ids.device != param.device:
        raise ValueError(f"ids is on {ids.device}, expected {param.device}")
    return fused_update_presummed(
        opt_type, args, *segment_sums(ids, upd), param, states, lr, step
    )


#: launches of the fused row-update kernel
fused_sorted_update.launches = 0


def segment_sums(ids: torch.Tensor, upd: torch.Tensor):
    """(sorted ids [n], segment number of every sorted position [n], summed
    rows [n, D]): a stable sort and one sum per segment of equal ids by the
    scatter kernel, deterministic. Rows of the sums past the last segment
    are zero. Nothing is read back to the host."""
    from kge_tpu_torch.ops.embedding_ops import scatter_add_presorted

    rs, order = torch.sort(ids.long(), stable=True)
    first = torch.ones_like(rs, dtype=torch.bool)
    first[1:] = rs[1:] != rs[:-1]
    seg = torch.cumsum(first, 0) - 1
    return rs, seg, scatter_add_presorted(seg, order, upd.contiguous(), rs.shape[0])


def fused_update_presummed(opt_type, args, ids_sorted, seg, gsum, param, states,
                           lr, step):
    """The kernel launch of ``fused_sorted_update`` on the products of
    ``segment_sums``; CUDA tensors only."""
    import ctypes

    from kge_tpu_torch.ops.kernel_utils import (
        check_launch,
        load_library,
        require,
        typed,
    )

    device = param.device
    if device.type != "cuda":
        raise ValueError(f"the fused update kernel takes CUDA tensors, got {device}")
    keys = sorted(states)  # the kernel takes the states in sorted key order
    require("param", param, device, torch.float32)
    for name in keys:
        require(f"state {name}", states[name], device, torch.float32)
    require("gsum", gsum, device, torch.float32)
    require("ids_sorted", ids_sorted, device, torch.int64)
    require("seg", seg, device, torch.int64)
    num_rows, D = param.shape
    if num_rows == 0 or D == 0:
        return states
    hyper, flags = _kernel_hyper(opt_type, args, lr, step)
    lib = load_library("fused_row_update")
    p, i = ctypes.c_void_p, ctypes.c_int
    launch = typed(lib, "fused_row_update_launch",
                    [i, p, p, p, i, i, ctypes.c_longlong, p, p, p, p, i, p, i, p])
    state_ptrs = [states[name].data_ptr() for name in keys] + [None] * 3
    with torch.cuda.device(device):
        code = launch(
            _KERNEL_RULE[opt_type], ids_sorted.data_ptr(), seg.data_ptr(),
            gsum.data_ptr(), ids_sorted.shape[0], D, num_rows, param.data_ptr(),
            state_ptrs[0], state_ptrs[1], state_ptrs[2], len(keys),
            hyper.ctypes.data, flags,
            torch.cuda.current_stream(device).cuda_stream,
        )
    check_launch(code, "fused_row_update")
    fused_sorted_update.launches += 1
    return states


class ParameterGroup:
    def __init__(self, name: str, opt_type: str, args: Dict[str, Any]):
        self.name = name
        self.opt_type = opt_type.lower()
        if self.opt_type not in _RULES:
            raise ValueError(f"unsupported optimizer type: {opt_type}")
        self.args = dict(args)
        self.args.pop("+++", None)
        lr = self.args.pop("lr", None)
        default_lr = _RULES[self.opt_type][2]
        if lr is None:
            if default_lr is None:
                raise ValueError(f"optimizer {opt_type} requires args.lr")
            lr = default_lr
        self.base_lr = float(lr)
        # torch-style betas may arrive as a list from yaml
        if "betas" in self.args:
            self.args["betas"] = tuple(self.args["betas"])


class KgeOptimizer:
    """Parameter-grouped optimizer over a model's parameter leaves.

    Groups are defined by ``train.optimizer.<group>.regex`` partitioning the
    reference-style parameter names; the ``default`` group takes the rest.
    Overlapping regexes are an error (reference optimizer.py:48-72).
    """

    def __init__(self, config: Config, leaves: Sequence[Leaf]):
        opt_cfg = config.get("train.optimizer")
        groups: List[ParameterGroup] = []
        regexes: List[Optional[str]] = []
        for name, spec in opt_cfg.items():
            if name in ("+++",):
                continue
            if name == "default":
                continue
            if "regex" not in spec:
                raise ValueError(
                    f"optimizer group {name} misses a regex key"
                )
            opt_type = spec.get("type", opt_cfg["default"].get("type", "Adagrad"))
            args = dict(opt_cfg["default"].get("args", {}))
            args.update(spec.get("args", {}))
            groups.append(ParameterGroup(name, opt_type, args))
            regexes.append(spec["regex"])
        default_spec = opt_cfg.get("default", {"type": "Adagrad", "args": {}})
        groups.append(
            ParameterGroup(
                "default", default_spec.get("type", "Adagrad"),
                default_spec.get("args", {}),
            )
        )
        regexes.append(None)
        self.groups = groups

        # assign each parameter leaf to exactly one group
        self._paths = [tuple(path) for path, _ in leaves]
        self.params = [param for _, param in leaves]
        names = [parameter_name(path) for path in self._paths]
        labels: List[int] = []
        for n in names:
            matched = [
                i for i, rgx in enumerate(regexes)
                if rgx is not None and re.search(rgx, n)
            ]
            if len(matched) > 1:
                raise ValueError(
                    f"parameter {n} matched by multiple optimizer groups: "
                    f"{[groups[i].name for i in matched]}"
                )
            labels.append(matched[0] if matched else len(groups) - 1)
        for i, g in enumerate(groups[:-1]):
            if i not in labels:
                raise ValueError(
                    f"optimizer group {g.name} (regex {regexes[i]}) matched "
                    "no parameters"
                )
        self._labels = labels
        self.parameter_names_list = names

    @staticmethod
    def create(config: Config, leaves: Sequence[Leaf]) -> "KgeOptimizer":
        return KgeOptimizer(config, leaves)

    @property
    def num_groups(self) -> int:
        return len(self.groups)

    def base_lrs(self) -> np.ndarray:
        return np.array([g.base_lr for g in self.groups], dtype=np.float32)

    @torch.no_grad()
    def init(self) -> Dict[str, Any]:
        states = []
        for param, label in zip(self.params, self._labels):
            g = self.groups[label]
            states.append(_RULES[g.opt_type][0](param, g.args))
        return {"leaves": states, "step": 0}

    @torch.no_grad()
    def update(self, grads: Sequence[torch.Tensor], opt_state: Dict[str, Any],
               lr: Sequence[float]) -> Dict[str, Any]:
        """Apply one optimizer step in place.

        ``lr`` holds the per-group learning rates (base lr x warmup x
        scheduler factor). The parameters and ``opt_state`` are updated and
        ``opt_state`` is returned.
        """
        return self.update_with_sparse_leaves(grads, opt_state, lr, sparse={})

    # -- sparse row updates ------------------------------------------------------

    def leaf_index(self, *path_keys: str) -> Optional[int]:
        """Index of the leaf at the given path of kge_tpu's parameter tree,
        or None when absent."""
        want = tuple(path_keys)
        for i, path in enumerate(self._paths):
            if path == want:
                return i
        return None

    def supports_sparse_rows(self, leaf_index: int) -> bool:
        """True when the leaf's rule is exact under row-sparse application:
        rows with zero gradient are fixed points (Adagrad without weight
        decay; SGD without momentum/weight decay)."""
        grp = self.groups[self._labels[leaf_index]]
        args = grp.args
        if args.get("weight_decay", 0.0):
            return False
        if grp.opt_type == "adagrad":
            return True
        if grp.opt_type == "sgd" and not args.get("momentum", 0.0):
            return True
        return False

    def supports_fused_rows(self, leaf_index: int) -> bool:
        """True when the leaf can take a one-pass dense-semantics update
        from row gradients (``fused_sorted_update``): any table rule. Adam's
        moment decay, weight decay etc. reach untouched rows through a zero
        gradient, exactly as on the dense step. Complements
        ``supports_sparse_rows``, which needs zero-gradient rows to be fixed
        points."""
        return self.groups[self._labels[leaf_index]].opt_type in _RULES

    @torch.no_grad()
    def fused_row_update(self, leaf_index: int, state_leaf: Dict[str, Any],
                         rows: torch.Tensor, row_grads: torch.Tensor,
                         lr: float, step: int) -> Dict[str, Any]:
        """Dense-semantics optimizer step of one leaf from row gradients,
        in place on the parameter and its state, without materializing the
        dense gradient (``fused_sorted_update``). Returns the leaf's
        state."""
        grp = self.groups[self._labels[leaf_index]]
        return fused_sorted_update(
            grp.opt_type, grp.args, rows, row_grads, self.params[leaf_index],
            state_leaf, lr, step,
        )

    @torch.no_grad()
    def sparse_row_update(self, leaf_index: int, state_leaf: Dict[str, Any],
                          rows: torch.Tensor, row_grads: torch.Tensor,
                          lr: float, step: int) -> Dict[str, Any]:
        """Update only the given (possibly duplicate) rows of one leaf, in
        place; exact equivalent of the dense rule for eligible optimizers.

        Duplicate rows are combined by a sorted segment sum (the scatter
        kernel serves it: a segment sum over sorted segment ids is a
        scatter-add, deterministic on the card); every position of a
        segment then writes the identical updated value, so the final row
        write is deterministic. Returns the leaf's new state.
        """
        from kge_tpu_torch.ops.embedding_ops import rows_set

        grp = self.groups[self._labels[leaf_index]]
        args = grp.args
        param = self.params[leaf_index]
        rs, seg, gsum = segment_sums(rows, row_grads)
        g = gsum[seg]  # per-position combined gradient of its row

        clr = _decayed_lr(lr, step, args.get("lr_decay", 0.0))
        if grp.opt_type == "adagrad":
            eps = args.get("eps", 1e-10)
            srows = state_leaf["sum"][rs] + g * g
            prows = param[rs] - clr * g / (torch.sqrt(srows) + eps)
            new_state = {"sum": rows_set(state_leaf["sum"], rs, srows)}
        elif grp.opt_type == "sgd":
            prows = param[rs] - clr * g
            new_state = state_leaf
        else:  # pragma: no cover - guarded by supports_sparse_rows
            raise NotImplementedError(grp.opt_type)
        rows_set(param, rs, prows)
        return new_state

    @torch.no_grad()
    def update_with_sparse_leaves(
        self, grads: Sequence[Optional[torch.Tensor]],
        opt_state: Dict[str, Any], lr: Sequence[float],
        sparse: Dict[int, Tuple[torch.Tensor, torch.Tensor]],
    ) -> Dict[str, Any]:
        """Like ``update`` but leaves in ``sparse`` (leaf index -> (rows,
        row_grads)) receive a row-sparse update; their entry in ``grads``
        is ignored (pass any placeholder)."""
        step = int(opt_state["step"])
        new_states = []
        for i, (g_leaf, param, s_leaf, label) in enumerate(zip(
            grads, self.params, opt_state["leaves"], self._labels
        )):
            grp = self.groups[label]
            if i in sparse:
                rows, row_grads = sparse[i]
                row_update = (
                    self.sparse_row_update if self.supports_sparse_rows(i)
                    else self.fused_row_update
                )
                new_states.append(row_update(
                    i, s_leaf, rows, row_grads, float(lr[label]), step
                ))
                continue
            update_fn = _RULES[grp.opt_type][1]
            delta, new_s = update_fn(
                g_leaf, s_leaf, param, float(lr[label]), step, grp.args
            )
            param.add_(delta)
            new_states.append(new_s)
        opt_state["leaves"] = new_states
        opt_state["step"] = step + 1
        return opt_state


class KgeLRScheduler:
    """Learning-rate scheduling with torch.optim.lr_scheduler semantics.

    Maintains a scalar multiplicative factor applied to all groups' base
    learning rates. Metric-based scheduling (ReduceLROnPlateau) is stepped
    only after validation epochs (reference optimizer.py:125-159).
    """

    def __init__(self, config: Config):
        self.config = config
        name = config.get("train.lr_scheduler")
        args = dict(config.get("train.lr_scheduler_args"))
        args.pop("+++", None)
        self._name = name
        self._args = args
        self._metric_based = name == "ReduceLROnPlateau"
        self._factor = 1.0
        self._epoch = 0
        # ReduceLROnPlateau state
        self._best = None
        self._num_bad_epochs = 0
        self._cooldown_counter = 0
        if name == "ReduceLROnPlateau":
            if "mode" not in args:
                mode = "max" if config.get("valid.metric_max") else "min"
                args["mode"] = mode
                config.log(
                    f"Setting ReduceLROnPlateau mode to {mode} from valid.metric_max"
                )
            if config.get("valid.every") <= 0:
                raise ValueError(
                    "metric-based lr scheduling requires validation "
                    "(valid.every > 0)"
                )
        elif name and name not in (
            "StepLR", "MultiStepLR", "ExponentialLR", "CosineAnnealingLR",
            "ConstantLR", "LinearLR",
        ):
            raise ValueError(f"unsupported lr scheduler: {name}")

    @property
    def metric_based(self) -> bool:
        return self._metric_based

    @property
    def factor(self) -> float:
        return self._factor

    def step(self, metric: Optional[float] = None):
        if not self._name:
            return
        self._epoch += 1
        a = self._args
        if self._name == "StepLR":
            if self._epoch % int(a.get("step_size", 1)) == 0:
                self._factor *= a.get("gamma", 0.1)
        elif self._name == "MultiStepLR":
            if self._epoch in set(a.get("milestones", [])):
                self._factor *= a.get("gamma", 0.1)
        elif self._name == "ExponentialLR":
            self._factor *= a.get("gamma", 1.0)
        elif self._name == "CosineAnnealingLR":
            t_max = a.get("T_max", 10)
            eta_min = a.get("eta_min", 0.0)
            self._factor = (
                eta_min + (1.0 - eta_min)
                * (1 + math.cos(math.pi * min(self._epoch, t_max) / t_max)) / 2
            )
        elif self._name == "ConstantLR":
            f = a.get("factor", 1.0 / 3)
            total = a.get("total_iters", 5)
            self._factor = f if self._epoch < total else 1.0
        elif self._name == "LinearLR":
            start = a.get("start_factor", 1.0 / 3)
            end = a.get("end_factor", 1.0)
            total = a.get("total_iters", 5)
            t = min(self._epoch, total)
            self._factor = start + (end - start) * t / total
        elif self._name == "ReduceLROnPlateau":
            if metric is None:
                return
            mode = a.get("mode", "max")
            threshold = a.get("threshold", 1e-4)
            threshold_mode = a.get("threshold_mode", "rel")
            patience = a.get("patience", 10)
            cooldown = a.get("cooldown", 0)
            factor = a.get("factor", 0.1)
            min_lr = a.get("min_lr", 0.0)

            def better(current, best):
                if threshold_mode == "rel":
                    eps = best * threshold if mode == "max" else -best * threshold
                    return current > best + eps if mode == "max" else \
                        current < best - best * threshold
                eps = threshold
                return current > best + eps if mode == "max" else \
                    current < best - eps

            if self._best is None or better(metric, self._best):
                self._best = metric
                self._num_bad_epochs = 0
            elif self._cooldown_counter > 0:
                self._cooldown_counter -= 1
                self._num_bad_epochs = 0
            else:
                self._num_bad_epochs += 1
                if self._num_bad_epochs > patience:
                    self._factor = max(self._factor * factor, min_lr)
                    self._cooldown_counter = cooldown
                    self._num_bad_epochs = 0
                    self.config.log(
                        f"Reduced learning-rate factor to {self._factor}"
                    )

    def state_dict(self) -> Dict[str, Any]:
        return {
            "factor": self._factor,
            "epoch": self._epoch,
            "best": self._best,
            "num_bad_epochs": self._num_bad_epochs,
            "cooldown_counter": self._cooldown_counter,
        }

    def load_state_dict(self, state: Dict[str, Any]):
        if not state:
            return
        self._factor = state.get("factor", 1.0)
        self._epoch = state.get("epoch", 0)
        self._best = state.get("best")
        self._num_bad_epochs = state.get("num_bad_epochs", 0)
        self._cooldown_counter = state.get("cooldown_counter", 0)
