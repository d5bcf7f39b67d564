"""The port's fused row update (ops/optim.py ``fused_sorted_update``, on the
CPU its plain version) against kge_tpu's Pallas kernel ``fused_sorted_update``
in interpret mode and against the dense rule, for all seven optimizer rules
with and without weight decay, with duplicate ids and untouched rows.

Tolerance: atol 1e-5 + rtol 1e-5 on the parameter and every state, which is
what kge_tpu's own test of its kernel allows (tests/test_pallas.py, atol
1e-5). Both sides evaluate the same float32 formulas; kge_tpu's kernel sums
the row gradients with one-hot matmuls over a 3-way bf16 split, this one in
float32, so a summed gradient differs by rounding. The states start from
random non-zero values with second moments of at least 0.01: from all-zero
moments Adam's first step is ``-lr * g / (|g| + eps)``, which turns the
rounding of a cancelling gradient into +-lr.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kge_tpu
import kge_tpu_torch
from kge_tpu.ops import optim as jax_optim
from kge_tpu.ops.pallas_ops import fused_sorted_update as jax_fused_sorted_update
from kge_tpu_torch.ops import optim as torch_optim
from kge_tpu_torch.ops.optim import (
    fused_sorted_update,
    fused_sorted_update_plain,
)

ROWS, D, N = 300, 128, 200  # D a multiple of 128: kge_tpu's kernel, not its fallback

RULES = [
    ("adagrad", {}),
    ("adagrad", {"weight_decay": 0.01, "lr_decay": 0.1}),
    ("adam", {}),
    ("adam", {"weight_decay": 0.01, "betas": (0.8, 0.99), "eps": 1e-6}),
    ("adamw", {}),
    ("adamw", {"weight_decay": 0.01}),
    ("adamax", {}),
    ("adamax", {"weight_decay": 0.01}),
    ("sgd", {}),
    ("sgd", {"weight_decay": 0.01}),
    ("sgd", {"momentum": 0.9, "dampening": 0.1, "weight_decay": 0.01}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {}),
    ("rmsprop", {"weight_decay": 0.01, "momentum": 0.9, "centered": True}),
    ("rmsprop", {"centered": True}),
    ("adadelta", {}),
    ("adadelta", {"weight_decay": 0.01, "rho": 0.8}),
]


def _case(opt_type, args, seed=0):
    """(param, states, ids, upd): ids with duplicates that leave most rows
    untouched; first moments in [-0.1, 0.1), second moments in [0.01, 0.11)."""
    rng = np.random.default_rng(seed)
    param = rng.normal(size=(ROWS, D)).astype(np.float32)
    keys = sorted(torch_optim._RULES[opt_type][0](torch.zeros(1, 1), args))
    states = {
        key: (rng.uniform(-0.1, 0.1, (ROWS, D)) if key in ("m", "momentum", "avg")
              else rng.uniform(0.01, 0.11, (ROWS, D))).astype(np.float32)
        for key in keys
    }
    ids = rng.integers(0, ROWS // 3, N)
    ids[:40] = 7  # a hot row
    upd = rng.normal(size=(N, D)).astype(np.float32)
    return param, states, ids, upd


def _jax_rule(opt_type, args, keys):
    update_fn = jax_optim._RULES[opt_type][1]

    def rule(g, p, state_tuple, lr, step):
        delta, new_state = update_fn(g, dict(zip(keys, state_tuple)), p, lr, step, args)
        return p + delta, tuple(new_state[k] for k in keys)

    return rule


def _assert_close(got, want, what):
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-5, rtol=1e-5,
                               err_msg=what)


@pytest.mark.parametrize("step", [0, 3])
@pytest.mark.parametrize("opt_type,args", RULES)
def test_fused_update_matches_jax_kernel_and_dense_rule(opt_type, args, step):
    param, states, ids, upd = _case(opt_type, args)
    keys = sorted(states)
    lr = 0.05
    rule = _jax_rule(opt_type, args, keys)

    def fresh():
        # copies: the kernel aliases its outputs to its inputs, and
        # jnp.asarray may share a numpy array's memory
        return jnp.array(param), tuple(jnp.array(states[k]) for k in keys)

    dense = jnp.zeros((ROWS, D), jnp.float32).at[jnp.asarray(ids)].add(
        jnp.asarray(upd))
    dense_p, dense_s = rule(dense, *fresh(), lr, step)
    want_p, want_s = jax_fused_sorted_update(
        jnp.asarray(ids), jnp.asarray(upd), *fresh(), lr, float(step), rule,
        interpret=True,
    )

    tparam = torch.tensor(param)
    tstates = {k: torch.tensor(v) for k, v in states.items()}
    pointers = [tparam.data_ptr()] + [tstates[k].data_ptr() for k in keys]
    out = fused_sorted_update(opt_type, args, torch.tensor(ids), torch.tensor(upd),
                              tparam, tstates, lr, step)
    # in place: the parameter and every state keep their storage
    assert out is tstates
    assert pointers == [tparam.data_ptr()] + [tstates[k].data_ptr() for k in keys]
    for want, name in ((want_p, "kge_tpu's kernel"), (dense_p, "the dense rule")):
        _assert_close(tparam.numpy(), want, f"param vs {name}")
    for i, key in enumerate(keys):
        _assert_close(tstates[key].numpy(), want_s[i], f"{key} vs kge_tpu's kernel")
        _assert_close(tstates[key].numpy(), dense_s[i], f"{key} vs the dense rule")
    # untouched rows take the rule with a zero gradient: whatever it does to
    # them (Adam's moments decay, weight decay pulls), kge_tpu does the same
    untouched = np.setdiff1d(np.arange(ROWS), ids)
    assert len(untouched) > ROWS // 2
    if opt_type in ("adam", "adamw", "adamax"):
        assert not np.array_equal(tstates["m"].numpy()[untouched],
                                  states["m"][untouched])
    if opt_type == "sgd" and not args:
        assert np.array_equal(tparam.numpy()[untouched], param[untouched])


def test_cpu_route_is_the_plain_version():
    param, states, ids, upd = _case("adam", {})
    results = []
    for fn in (fused_sorted_update, fused_sorted_update_plain):
        p = torch.tensor(param)
        st = {k: torch.tensor(v) for k, v in states.items()}
        fn("adam", {}, torch.tensor(ids), torch.tensor(upd), p, st, 0.01, 2)
        results.append((p, st))
    (p1, s1), (p2, s2) = results
    assert torch.equal(p1, p2) and all(torch.equal(s1[k], s2[k]) for k in s1)
    assert fused_sorted_update.launches == 0  # the kernel runs on CUDA tensors only


def test_no_row_gradients_still_steps_every_row():
    """n = 0: dense semantics with an all-zero gradient."""
    param, states, _, _ = _case("adam", {"weight_decay": 0.1})
    args = {"weight_decay": 0.1}
    p = torch.tensor(param)
    st = {k: torch.tensor(v) for k, v in states.items()}
    fused_sorted_update("adam", args, torch.zeros(0, dtype=torch.long),
                        torch.zeros(0, D), p, st, 0.01, 1)
    dense_p = torch.tensor(param)
    delta, dense_s = torch_optim._RULES["adam"][1](
        torch.zeros(ROWS, D), {k: torch.tensor(v) for k, v in states.items()},
        dense_p, 0.01, 1, args)
    assert torch.equal(p, dense_p + delta)
    assert all(torch.equal(st[k], dense_s[k]) for k in st)
    assert not torch.equal(p, torch.tensor(param))


@pytest.mark.parametrize("bad", ["upd_shape", "state_shape", "ids_rank"])
def test_wrapper_checks_shapes(bad):
    param, states, ids, upd = _case("adam", {})
    p = torch.tensor(param)
    st = {k: torch.tensor(v) for k, v in states.items()}
    ids, upd = torch.tensor(ids), torch.tensor(upd)
    if bad == "upd_shape":
        upd = upd[:, :-1]
    elif bad == "state_shape":
        st["m"] = st["m"][:-1]
    else:
        ids = ids[None, :]
    with pytest.raises(ValueError):
        fused_sorted_update("adam", {}, ids, upd, p, st, 0.01, 0)


def test_kernel_hyperparameters_are_the_plain_versions_scalars():
    """What the CUDA kernel is handed equals what the plain rules compute on
    the host, in float32: bias corrections, decayed learning rate, 1 - beta."""
    names = ("lr", "wd", "eps", "b1", "omb1", "b2", "omb2", "c1", "c2",
             "momentum", "omd", "lrwd")
    hyper, flags = torch_optim._kernel_hyper(
        "adamw", {"betas": (0.8, 0.99), "weight_decay": 0.1}, 0.01, 4)
    h = dict(zip(names, hyper))
    assert hyper.dtype == np.float32 and flags == 8
    assert h["c1"] == np.float32(torch_optim._one_minus_pow(0.8, 5))
    assert h["c2"] == np.float32(torch_optim._one_minus_pow(0.99, 5))
    assert h["omb1"] == np.float32(1 - 0.8) and h["lrwd"] == np.float32(0.01 * 0.1)
    hyper, flags = torch_optim._kernel_hyper("adagrad", {"lr_decay": 0.5}, 0.1, 3)
    assert dict(zip(names, hyper))["lr"] == np.float32(
        torch_optim._decayed_lr(0.1, 3, 0.5))
    hyper, flags = torch_optim._kernel_hyper(
        "sgd", {"momentum": 0.9, "nesterov": True, "dampening": 0.25}, 0.1, 0)
    assert flags == 1 | 2 and dict(zip(names, hyper))["omd"] == np.float32(0.75)
    _, flags = torch_optim._kernel_hyper("rmsprop", {"centered": True}, 0.1, 1)
    assert flags == 4
    hyper, _ = torch_optim._kernel_hyper("adamax", {}, 0.002, 1)
    assert dict(zip(names, hyper))["c1"] == np.float32(
        np.float32(-0.002) / np.float32(torch_optim._one_minus_pow(0.9, 2)))
    with pytest.raises(ValueError):
        torch_optim._kernel_hyper("lion", {}, 0.1, 0)


# -- through the optimizer, as the row-sparse training step calls it -------------

PATHS = [("entity_embedder", "embeddings"), ("relation_embedder", "embeddings")]


def _configs(options):
    out = []
    for package in (kge_tpu, kge_tpu_torch):
        config = package.Config()
        config.set("console.quiet", True)
        for key, value in options.items():
            config.set(key, value, create=True)
        out.append(config)
    return out


@pytest.mark.parametrize("opt_type,args", [
    ("Adam", {"lr": 0.01}), ("AdamW", {"lr": 0.01, "weight_decay": 0.05}),
    ("Adagrad", {"lr": 0.1, "weight_decay": 0.01}),
    ("SGD", {"lr": 0.1, "momentum": 0.9}),
])
def test_update_with_sparse_leaves_matches_jax(opt_type, args):
    """Three steps of ``update_with_sparse_leaves`` with both tables sparse,
    in both packages; D = 128, so kge_tpu runs its kernel (interpreted). The
    rules here have no zero-gradient fixed points, so both packages take the
    fused update for them. The first step starts from zero moments: the row
    gradients are positive, so that no sum cancels (module docstring)."""
    rng = np.random.default_rng(5)
    tables = [rng.normal(size=(40, D)).astype(np.float32),
              rng.normal(size=(5, D)).astype(np.float32)]
    options = {"train.optimizer.default.type": opt_type}
    options.update({f"train.optimizer.default.args.{k}": v for k, v in args.items()})
    jconfig, tconfig = _configs(options)
    params = {"entity_embedder": {"embeddings": jnp.array(tables[0])},
              "relation_embedder": {"embeddings": jnp.array(tables[1])}}
    jopt = jax_optim.KgeOptimizer.create(jconfig, params)
    jstate = jopt.init(params)
    topt = torch_optim.KgeOptimizer.create(
        tconfig, [(path, torch.tensor(t)) for path, t in zip(PATHS, tables)])
    tstate = topt.init()
    assert not topt.supports_sparse_rows(0) and topt.supports_fused_rows(0)
    for step in range(3):
        rows = [rng.integers(0, 12, 16), rng.integers(0, 5, 16)]
        grads = [rng.uniform(0.1, 1.0, (16, D)).astype(np.float32) for _ in rows]
        lr = jopt.base_lrs()
        params, jstate = jopt.update_with_sparse_leaves(
            params, jstate, params, jnp.asarray(lr),
            sparse={i: (jnp.asarray(rows[i]), jnp.asarray(grads[i])) for i in (0, 1)},
        )
        tstate = topt.update_with_sparse_leaves(
            [None, None], tstate, lr,
            sparse={i: (torch.tensor(rows[i]), torch.tensor(grads[i])) for i in (0, 1)},
        )
        for i, key in enumerate(("entity_embedder", "relation_embedder")):
            _assert_close(topt.params[i].numpy(), params[key]["embeddings"], key)
            assert sorted(tstate["leaves"][i]) == sorted(jstate["leaves"][i])
            for name, value in jstate["leaves"][i].items():
                _assert_close(tstate["leaves"][i][name].numpy(), value, name)
    assert int(tstate["step"]) == int(jstate["step"]) == 3
