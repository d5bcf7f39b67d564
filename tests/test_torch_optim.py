"""kge_tpu_torch/ops/losses.py, ops/optim.py and the model penalties against
kge_tpu on the CPU, from the same numpy inputs.

Tolerances: both packages evaluate the same float32 formulas term for term,
so one optimizer step and one loss agree to rtol 1e-5 (atol 1e-6 where
values cross zero); the bias terms of Adam and Adamax go through exp/log,
which XLA and numpy round differently in the last bit."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kge_tpu
import kge_tpu_torch
from kge_tpu.ops import losses as jax_losses
from kge_tpu.ops import optim as jax_optim
from kge_tpu_torch.models.convert import load_jax_opt_state, to_jax_opt_state
from kge_tpu_torch.ops import losses as torch_losses
from kge_tpu_torch.ops import optim as torch_optim
from tests.torch_parity import make_pair
from tests.util import DATASET_DIR

PATHS = (("entity_embedder", "embeddings"), ("relation_embedder", "embeddings"))


def _configs(options):
    out = []
    for package in (kge_tpu, kge_tpu_torch):
        config = package.Config()
        config.set("console.quiet", True)
        for key, value in options.items():
            config.set(key, value, create=True)
        out.append(config)
    return out


# -- losses ---------------------------------------------------------------------


@pytest.mark.parametrize("labels_kind", ["index", "matrix"])
@pytest.mark.parametrize("name,arg", [
    ("bce", float("nan")), ("bce", 0.5), ("bce_mean", float("nan")),
    ("bce_self_adversarial", float("nan")), ("margin_ranking", float("nan")),
    ("margin_ranking", 2.0), ("ce", float("nan")), ("kl", float("nan")),
    ("soft_margin", float("nan")), ("se", float("nan")),
])
def test_loss_matches_jax(name, arg, labels_kind):
    rng = np.random.default_rng(5)
    n, m = 9, 6
    scores = (3 * rng.normal(size=(n, m))).astype(np.float32)
    if labels_kind == "index":
        labels = np.zeros(n, dtype=np.int64)
    elif name in ("kl", "ce"):
        labels = (rng.random((n, m)) < 0.4).astype(np.float32)
        labels[0] = 0.0  # an all-zero row, as padding leaves
    else:
        labels = np.zeros((n, m), dtype=np.float32)
        labels[:, 0] = 1.0
    jconfig, tconfig = _configs({
        "train.loss": name, "train.loss_arg": arg,
        "train.type": "negative_sampling",
    })
    jloss = jax_losses.KgeLoss.create(jconfig)
    tloss = torch_losses.KgeLoss.create(tconfig)
    assert type(tloss).__name__ == type(jloss).__name__
    assert tconfig.get("train.loss_arg") == jconfig.get("train.loss_arg") or (
        np.isnan(tconfig.get("train.loss_arg"))
        and np.isnan(jconfig.get("train.loss_arg"))
    )

    def jf(s):
        return jloss(s, jnp.asarray(labels))

    want, want_grad = jax.value_and_grad(jf)(jnp.asarray(scores))
    s = torch.tensor(scores, requires_grad=True)
    t_labels = torch.tensor(labels)
    got = tloss(s, t_labels)
    (grad,) = torch.autograd.grad(got, s)
    np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               rtol=1e-5, atol=1e-6)
    # the per-row terms are kge_tpu's loss of each row alone
    rows = tloss.rows(s.detach(), t_labels).numpy()
    want_rows = [float(jloss(jnp.asarray(scores[i:i + 1]),
                             jnp.asarray(labels[i:i + 1]))) for i in range(n)]
    np.testing.assert_allclose(rows, want_rows, rtol=1e-5, atol=1e-6)


def test_loss_factory_errors_match():
    jconfig, tconfig = _configs({"train.loss": "margin_ranking",
                                 "train.type": "KvsAll"})
    with pytest.raises(NotImplementedError):
        jax_losses.KgeLoss.create(jconfig)
    with pytest.raises(NotImplementedError):
        torch_losses.KgeLoss.create(tconfig)
    for config, module in zip(_configs({"train.loss": "nope"}),
                              (jax_losses, torch_losses)):
        with pytest.raises(ValueError):
            module.KgeLoss.create(config)


# -- optimizer rules ------------------------------------------------------------

RULE_CASES = [
    ("Adagrad", {"lr": 0.1}),
    ("Adagrad", {"lr": 0.1, "weight_decay": 0.01, "lr_decay": 0.1,
                 "initial_accumulator_value": 0.05}),
    ("Adam", {"lr": 0.01}),
    ("Adam", {"lr": 0.01, "weight_decay": 0.01, "betas": [0.8, 0.99]}),
    ("AdamW", {"lr": 0.01, "weight_decay": 0.05}),
    ("Adamax", {"lr": 0.02, "weight_decay": 0.01}),
    ("SGD", {"lr": 0.1}),
    ("SGD", {"lr": 0.1, "momentum": 0.9, "weight_decay": 0.01}),
    ("SGD", {"lr": 0.1, "momentum": 0.9, "dampening": 0.1}),
    ("SGD", {"lr": 0.1, "momentum": 0.9, "nesterov": True}),
    ("RMSprop", {}),
    ("RMSprop", {"lr": 0.01, "momentum": 0.5, "centered": True,
                 "weight_decay": 0.01}),
    ("Adadelta", {}),
    ("Adadelta", {"lr": 0.5, "rho": 0.8, "weight_decay": 0.01}),
]


def _tables(rng):
    return [rng.normal(size=shape).astype(np.float32)
            for shape in ((7, 8), (3, 8))]


def _jax_tree(tables):
    return {"entity_embedder": {"embeddings": jnp.asarray(tables[0])},
            "relation_embedder": {"embeddings": jnp.asarray(tables[1])}}


def _torch_leaves(tables):
    return [(path, torch.tensor(t)) for path, t in zip(PATHS, tables)]


def _optimizer_options(opt_type, args, **groups):
    options = {"train.optimizer.default.type": opt_type}
    for key, value in args.items():
        options[f"train.optimizer.default.args.{key}"] = value
    options.update(groups)
    return options


@pytest.mark.parametrize("opt_type,args", RULE_CASES)
def test_optimizer_steps_match_jax(opt_type, args):
    """Three steps (step 0, 1 and 2) of every rule of ``_RULES``, with a
    learning rate that changes between steps as a scheduler would."""
    rng = np.random.default_rng(11)
    tables = _tables(rng)
    jconfig, tconfig = _configs(_optimizer_options(opt_type, args))
    params = _jax_tree(tables)
    jopt = jax_optim.KgeOptimizer.create(jconfig, params)
    jstate = jopt.init(params)
    topt = torch_optim.KgeOptimizer.create(tconfig, _torch_leaves(tables))
    tstate = topt.init()
    assert topt.parameter_names_list == jopt.parameter_names_list
    np.testing.assert_array_equal(topt.base_lrs(), jopt.base_lrs())
    for step, factor in enumerate((1.0, 0.5, 0.25)):
        grads = _tables(rng)
        lr = jopt.base_lrs() * np.float32(factor)
        params, jstate = jopt.update(_jax_tree(grads), jstate, params,
                                     jnp.asarray(lr))
        tstate = topt.update([torch.tensor(g) for g in grads], tstate, lr)
        assert int(tstate["step"]) == int(jstate["step"]) == step + 1
        want = [params["entity_embedder"]["embeddings"],
                params["relation_embedder"]["embeddings"]]
        for got, w in zip(topt.params, want):
            np.testing.assert_allclose(got.numpy(), np.asarray(w),
                                       rtol=1e-5, atol=1e-6)
        for got_s, want_s in zip(tstate["leaves"], jstate["leaves"]):
            assert sorted(got_s) == sorted(want_s)
            for key in want_s:
                np.testing.assert_allclose(got_s[key].numpy(),
                                           np.asarray(want_s[key]),
                                           rtol=1e-5, atol=1e-6)


def test_regex_groups_match_jax():
    """A relation group with its own rule and learning rate."""
    rng = np.random.default_rng(12)
    tables = _tables(rng)
    options = _optimizer_options(
        "Adagrad", {"lr": 0.1},
        **{"train.optimizer.rel.regex": ".*_relation_embedder.*",
           "train.optimizer.rel.type": "SGD",
           "train.optimizer.rel.args.lr": 0.5},
    )
    jconfig, tconfig = _configs(options)
    params = _jax_tree(tables)
    jopt = jax_optim.KgeOptimizer.create(jconfig, params)
    topt = torch_optim.KgeOptimizer.create(tconfig, _torch_leaves(tables))
    assert topt._labels == jopt._labels == [1, 0]
    assert [g.opt_type for g in topt.groups] == [g.opt_type for g in jopt.groups]
    grads = _tables(rng)
    lr = jopt.base_lrs()
    params, _ = jopt.update(_jax_tree(grads), jopt.init(params), params,
                            jnp.asarray(lr))
    topt.update([torch.tensor(g) for g in grads], topt.init(), lr)
    np.testing.assert_allclose(
        topt.params[1].numpy(),
        np.asarray(params["relation_embedder"]["embeddings"]), rtol=1e-6)
    np.testing.assert_allclose(
        topt.params[0].numpy(),
        np.asarray(params["entity_embedder"]["embeddings"]), rtol=1e-5)
    for leaf in (0, 1):
        assert topt.supports_sparse_rows(leaf) == jopt.supports_sparse_rows(leaf)
        assert topt.supports_fused_rows(leaf) == jopt.supports_fused_rows(leaf)
    assert topt.leaf_index("relation_embedder", "embeddings") == jopt.leaf_index(
        params, "relation_embedder", "embeddings") == 1
    assert topt.leaf_index("scorer", "w") is None


@pytest.mark.parametrize("groups,message", [
    ({"train.optimizer.a.regex": ".*_entity.*",
      "train.optimizer.b.regex": ".*embedder.*"}, "multiple optimizer groups"),
    ({"train.optimizer.a.regex": "nothing_matches"}, "matched no parameters"),
    ({"train.optimizer.a.type": "SGD"}, "misses a regex key"),
    ({"train.optimizer.default.type": "Lion"}, "unsupported optimizer type"),
])
def test_optimizer_group_errors_match_jax(groups, message):
    rng = np.random.default_rng(0)
    tables = _tables(rng)
    jconfig, tconfig = _configs(_optimizer_options("Adagrad", {}, **groups))
    with pytest.raises(ValueError, match=message):
        jax_optim.KgeOptimizer.create(jconfig, _jax_tree(tables))
    with pytest.raises(ValueError, match=message):
        torch_optim.KgeOptimizer.create(tconfig, _torch_leaves(tables))


def test_sgd_requires_lr():
    for config, module, params in zip(
        _configs({"train.optimizer.default.type": "SGD"}),
        (jax_optim, torch_optim),
        (_jax_tree(_tables(np.random.default_rng(0))),
         _torch_leaves(_tables(np.random.default_rng(0)))),
    ):
        with pytest.raises(ValueError, match="requires args.lr"):
            module.KgeOptimizer.create(config, params)


@pytest.mark.parametrize("opt_type,args", [
    ("Adagrad", {"lr": 0.1}), ("Adagrad", {"lr": 0.1, "lr_decay": 0.2}),
    ("SGD", {"lr": 0.3}),
])
def test_sparse_row_update_matches_jax(opt_type, args):
    """Row-sparse update of the entity table with duplicate rows, two
    steps; rows that the update does not name keep their bits."""
    rng = np.random.default_rng(13)
    tables = [rng.normal(size=(40, 8)).astype(np.float32),
              rng.normal(size=(3, 8)).astype(np.float32)]
    jconfig, tconfig = _configs(_optimizer_options(opt_type, args))
    params = _jax_tree(tables)
    jopt = jax_optim.KgeOptimizer.create(jconfig, params)
    jstate = jopt.init(params)
    topt = torch_optim.KgeOptimizer.create(tconfig, _torch_leaves(tables))
    tstate = topt.init()
    for step in range(2):
        rows = np.array([5, 9, 5, 31, 9, 5, 0, 12])
        row_grads = rng.normal(size=(8, 8)).astype(np.float32)
        rel_grad = rng.normal(size=(3, 8)).astype(np.float32)
        lr = jopt.base_lrs()
        before = topt.params[0].clone()
        params, jstate = jopt.update_with_sparse_leaves(
            _jax_tree([tables[0] * 0, rel_grad]), jstate, params,
            jnp.asarray(lr), sparse={0: (jnp.asarray(rows), jnp.asarray(row_grads))},
        )
        tstate = topt.update_with_sparse_leaves(
            [None, torch.tensor(rel_grad)], tstate, lr,
            sparse={0: (torch.tensor(rows), torch.tensor(row_grads))},
        )
        np.testing.assert_allclose(
            topt.params[0].numpy(),
            np.asarray(params["entity_embedder"]["embeddings"]),
            rtol=1e-5, atol=1e-6)
        np.testing.assert_allclose(
            topt.params[1].numpy(),
            np.asarray(params["relation_embedder"]["embeddings"]),
            rtol=1e-5, atol=1e-6)
        untouched = np.setdiff1d(np.arange(40), rows)
        assert torch.equal(topt.params[0][untouched], before[untouched])
        for key, value in jstate["leaves"][0].items():
            np.testing.assert_allclose(tstate["leaves"][0][key].numpy(),
                                       np.asarray(value), rtol=1e-5, atol=1e-6)


def test_sparse_leaf_of_other_rules_names_the_missing_kernel():
    """The kernel is there now: a sparse leaf of a rule without fixed points
    (Adam) takes the fused dense-semantics update and no longer raises. One
    row gradient moves its row as the dense rule does; every other row
    takes the rule with a zero gradient (here: stays, since m = v = 0)."""
    tables = _tables(np.random.default_rng(0))
    (_, tconfig) = _configs(_optimizer_options("Adam", {}))
    topt = torch_optim.KgeOptimizer.create(tconfig, _torch_leaves(tables))
    dense = torch_optim.KgeOptimizer.create(tconfig, _torch_leaves(tables))
    row_grad = torch.full((1, 8), 0.5)
    topt.update_with_sparse_leaves(
        [None, torch.zeros(3, 8)], topt.init(), topt.base_lrs(),
        sparse={0: (torch.tensor([1]), row_grad)},
    )
    grad = torch.zeros_like(dense.params[0])
    grad[1] = row_grad[0]
    dense.update([grad, torch.zeros(3, 8)], dense.init(), dense.base_lrs())
    assert torch.equal(topt.params[0], dense.params[0])
    assert not torch.equal(topt.params[0][1], torch.tensor(tables[0][1]))


def test_optimizer_state_round_trip():
    """kge_tpu's optimizer state -> this package's -> kge_tpu's."""
    rng = np.random.default_rng(14)
    tables = _tables(rng)
    jconfig, tconfig = _configs(_optimizer_options("Adam", {}))
    params = _jax_tree(tables)
    jopt = jax_optim.KgeOptimizer.create(jconfig, params)
    _, jstate = jopt.update(_jax_tree(_tables(rng)), jopt.init(params), params,
                            jnp.asarray(jopt.base_lrs()))
    as_numpy = jax.tree_util.tree_map(np.asarray, jstate)
    tstate = load_jax_opt_state(as_numpy, _torch_leaves(tables))
    assert tstate["step"] == 1
    back = to_jax_opt_state(tstate)
    assert back["step"].dtype == np.int32 and int(back["step"]) == 1
    assert jax.tree_util.tree_structure(back) == jax.tree_util.tree_structure(as_numpy)
    for got, want in zip(jax.tree_util.tree_leaves(back),
                         jax.tree_util.tree_leaves(as_numpy)):
        np.testing.assert_array_equal(got, want)
    with pytest.raises(ValueError):
        load_jax_opt_state({"leaves": as_numpy["leaves"][:1], "step": 0},
                           _torch_leaves(tables))


# -- learning-rate schedulers ---------------------------------------------------

SCHEDULERS = [
    ("", {}),
    ("StepLR", {"step_size": 2, "gamma": 0.5}),
    ("MultiStepLR", {"milestones": [2, 5], "gamma": 0.3}),
    ("ExponentialLR", {"gamma": 0.9}),
    ("CosineAnnealingLR", {"T_max": 6, "eta_min": 0.1}),
    ("ConstantLR", {"factor": 0.25, "total_iters": 3}),
    ("LinearLR", {"start_factor": 0.2, "total_iters": 4}),
    ("ReduceLROnPlateau", {"patience": 1, "factor": 0.5, "cooldown": 1}),
    ("ReduceLROnPlateau", {"patience": 0, "factor": 0.1, "mode": "min",
                           "threshold_mode": "abs", "threshold": 0.01,
                           "min_lr": 0.05}),
]


@pytest.mark.parametrize("name,args", SCHEDULERS)
def test_lr_scheduler_matches_jax_step_for_step(name, args):
    options = {"train.lr_scheduler": name, "valid.every": 1}
    options.update({f"train.lr_scheduler_args.{k}": v for k, v in args.items()})
    jconfig, tconfig = _configs(options)
    jsched = jax_optim.KgeLRScheduler(jconfig)
    tsched = torch_optim.KgeLRScheduler(tconfig)
    assert tsched.metric_based == jsched.metric_based
    metrics = [0.3, 0.35, 0.34, 0.33, 0.36, 0.36, 0.2, 0.1, 0.1, 0.5]
    for i, metric in enumerate(metrics):
        arg = (metric,) if jsched.metric_based else ()
        jsched.step(*arg)
        tsched.step(*arg)
        assert tsched.factor == jsched.factor, (i, tsched.factor, jsched.factor)
        assert tsched.state_dict() == jsched.state_dict()
    restored = torch_optim.KgeLRScheduler(tconfig)
    restored.load_state_dict(jsched.state_dict())
    assert restored.state_dict() == jsched.state_dict()


def test_lr_scheduler_errors_match_jax():
    for config, module in zip(_configs({"train.lr_scheduler": "Nope"}),
                              (jax_optim, torch_optim)):
        with pytest.raises(ValueError, match="unsupported lr scheduler"):
            module.KgeLRScheduler(config)
    for config, module in zip(
        _configs({"train.lr_scheduler": "ReduceLROnPlateau", "valid.every": 0}),
        (jax_optim, torch_optim),
    ):
        with pytest.raises(ValueError, match="requires validation"):
            module.KgeLRScheduler(config)


# -- penalties ------------------------------------------------------------------

PENALTY_CASES = [
    {"lookup_embedder.regularize": "lp", "lookup_embedder.regularize_weight": 0.1},
    {"lookup_embedder.regularize": "lp", "lookup_embedder.regularize_weight": 0.1,
     "lookup_embedder.regularize_args.p": 3},
    {"lookup_embedder.regularize": "n3", "lookup_embedder.regularize_weight": 0.05,
     "lookup_embedder.space": "complex"},
    {"lookup_embedder.regularize": "lp", "lookup_embedder.regularize_weight": 0.1,
     "lookup_embedder.regularize_args.weighted": True},
    {"lookup_embedder.regularize": "lp", "lookup_embedder.regularize_weight": 0.1,
     "lookup_embedder.regularize_args.weighted": True,
     "lookup_embedder.regularize_args.p": 3},
    {"lookup_embedder.regularize": "n3", "lookup_embedder.regularize_weight": 0.05,
     "lookup_embedder.space": "complex",
     "lookup_embedder.regularize_args.weighted": True},
    {"lookup_embedder.regularize": "", "lookup_embedder.regularize_weight": 0.1},
    {"lookup_embedder.regularize": "lp", "lookup_embedder.regularize_weight": 0.1,
     "complex.entity_embedder.regularize_args.weighted": True},
]


@pytest.mark.parametrize("model", ["complex", "reciprocal_complex"])
@pytest.mark.parametrize("case", range(len(PENALTY_CASES)))
def test_penalty_matches_jax(case, model):
    """Values and table gradients of the penalty terms, with a padded batch
    (mask), with an unpadded one, and without a batch. kge_tpu raises on a
    weighted relation penalty with a mask (its weight broadcast takes
    two-dimensional indexes only), so that combination is held against the
    unpadded batch instead (test_weighted_relation_penalty_with_mask)."""
    from tests.torch_parity import model_options

    options = dict(model_options(model, dim=8))
    options.update(PENALTY_CASES[case])
    if model != "complex":
        options = {k.replace("complex.", "reciprocal_relations_model.base_model."): v
                   for k, v in options.items()}
    relation_weighted = options.get("lookup_embedder.regularize_args.weighted")
    weighted = any(k.endswith("regularize_args.weighted") for k in options)
    jmodel, params, tmodel = make_pair(DATASET_DIR, "dataset_test", options)
    triples = np.array([[0, 1, 2], [3, 0, 4], [0, 1, 5], [6, 2, 6], [6, 2, 6]])
    mask = np.array([1, 1, 1, 1, 0], dtype=np.float32)
    for batch in ({"triples": triples, "mask": mask}, {"triples": triples}, None):
        if relation_weighted and batch is not None and "mask" in batch:
            continue
        if weighted and batch is None:
            jparams = jax.tree_util.tree_map(jnp.asarray, params)
            with pytest.raises(ValueError, match="requires batch indexes"):
                jmodel.penalty(jparams, batch=None, epoch=1)
            with pytest.raises(ValueError, match="requires batch indexes"):
                tmodel.penalty(batch=None, epoch=1)
            continue
        jbatch = None if batch is None else {
            k: jnp.asarray(v) for k, v in batch.items()}
        tbatch = None if batch is None else {
            k: torch.tensor(v) for k, v in batch.items()}

        def total(p):
            return sum((v for _, v in jmodel.penalty(p, batch=jbatch, epoch=1)),
                       jnp.zeros(()))

        jparams = jax.tree_util.tree_map(jnp.asarray, params)
        want = jmodel.penalty(jparams, batch=jbatch, epoch=1)
        got = tmodel.penalty(batch=tbatch, epoch=1)
        assert [n for n, _ in got] == [n for n, _ in want]
        for (_, g), (_, w) in zip(got, want):
            np.testing.assert_allclose(float(g.detach()), float(w), rtol=1e-5)
        if not want:
            continue
        want_grads = jax.grad(total)(jparams)
        leaves = [tmodel.get_s_embedder().embeddings,
                  tmodel.get_p_embedder().embeddings]
        grads = torch.autograd.grad(sum(v for _, v in got), leaves)
        for g, key in zip(grads, ("entity_embedder", "relation_embedder")):
            np.testing.assert_allclose(
                g.numpy(), np.asarray(want_grads[key]["embeddings"]),
                rtol=1e-5, atol=1e-6)


def test_weighted_relation_penalty_with_mask():
    """A padded batch's weighted penalties equal the unpadded batch's."""
    from tests.torch_parity import model_options

    options = dict(model_options("complex", dim=8))
    options.update(PENALTY_CASES[3])
    _, _, tmodel = make_pair(DATASET_DIR, "dataset_test", options)
    triples = torch.tensor([[0, 1, 2], [3, 0, 4], [0, 1, 5], [6, 2, 6], [6, 2, 6]])
    mask = torch.tensor([1.0, 1.0, 1.0, 1.0, 0.0])
    padded = tmodel.penalty(batch={"triples": triples, "mask": mask})
    plain = tmodel.penalty(batch={"triples": triples[:4]})
    assert len(padded) == len(plain) == 2
    for (_, a), (_, b) in zip(padded, plain):
        np.testing.assert_allclose(float(a.detach()), float(b.detach()), rtol=1e-6)
