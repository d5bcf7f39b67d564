"""The neural models of kge_tpu_torch, ConvE and the Transformer, against
kge_tpu on the CPU (reciprocal relations model over ConvE at d = 32 and over
the Transformer at d = 16 with 2 heads and 2 layers, tests/data/
dataset_test, weights made by kge_tpu and carried across through numpy,
every dropout 0):

- scores of ``spo`` in both directions, ``sp_`` and ``_po`` in eval mode
  (random batch-norm statistics) and in train mode, with the statistics the
  call collects;
- the optimizer's leaves, their order and names (a regex group over the
  scorer selects the same leaves), and the number of parameters;
- configuration: the ``+1`` bias column, ``round_dim`` and the aspect-ratio
  refusal, and the messages for slots other than o;
- an epoch's training steps through both jobs' raw steps on a seeded
  synthetic graph (batches of 32, the last one padded; 1vsAll with Adam and
  weight decay, KvsAll with label smoothing and Adagrad, negative sampling
  of o with Adagrad): losses rtol 1e-5, tables and scorer parameters atol
  5e-6, statistics and optimizer state within 5e-6 + 1e-5 of their
  leaf's largest magnitude;
- filtered entity-ranking metrics exactly, the port ranking through the
  rank kernel's plain version;
- examples/toy-conve-train.yaml through ``start``, and checkpoints that
  cross both ways through the command line, optimizer state included.
"""

import math
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import yaml

import kge_tpu
import kge_tpu_torch
from kge_tpu.job import EvaluationJob as JaxEvaluationJob
from kge_tpu.models.base import Ctx, EVAL_CTX
from kge_tpu_torch.job import EvaluationJob
from kge_tpu_torch.models import load_jax_params
from tests.test_torch_cli import EXAMPLES_DIR, _entries, _metrics, _run, _toy_cwd
from tests.torch_parity import (
    jax_tables,
    make_config,
    make_job_pair,
    make_pair,
    neural_options,
    random_stats,
    run_batch_steps,
    run_steps,
    torch_tables,
)
from tests.util import DATASET_DIR, make_synthetic_dataset

MODELS = ["conve", "transformer"]
STATS = ("bn1_mean", "bn1_var", "bn2_mean", "bn2_var")


def _pair(model, seed=0, **extra):
    """(jax model, params with random statistics, torch model)."""
    jmodel, params, tmodel = make_pair(
        DATASET_DIR, "dataset_test", neural_options(model, **extra), seed=seed)
    params = random_stats(params)
    load_jax_params(tmodel, params)
    return jmodel, params, tmodel


def _queries(seed=0, n=9):
    rng = np.random.default_rng(seed)
    return rng.integers(0, 7, n), rng.integers(0, 3, n), rng.integers(0, 7, n)


def _close(got, want):
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5 * np.abs(want).max())


# -- scores -------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["eval", "train"])
@pytest.mark.parametrize("model", MODELS)
def test_scores_match_kge_tpu(model, mode):
    jmodel, params, tmodel = _pair(model)
    s, p, o = _queries()
    ts, tp, to = (torch.tensor(a) for a in (s, p, o))
    tmodel.train(mode == "train")
    ctx = Ctx(train=True, rng=None, stats={}) if mode == "train" else EVAL_CTX
    forms = {
        "spo_o": (lambda c: jmodel.score_spo(params, s, p, o, "o", c),
                  lambda: tmodel.score_spo(ts, tp, to, "o")),
        "spo_s": (lambda c: jmodel.score_spo(params, s, p, o, "s", c),
                  lambda: tmodel.score_spo(ts, tp, to, "s")),
        "sp_": (lambda c: jmodel.score_sp(params, s, p, ctx=c),
                lambda: tmodel.score_sp(ts, tp)),
        "_po": (lambda c: jmodel.score_po(params, p, o, ctx=c),
                lambda: tmodel.score_po(tp, to)),
    }
    for name, (jax_form, torch_form) in forms.items():
        c = Ctx(train=True, rng=None, stats={}) if mode == "train" else ctx
        want = jax_form(c)
        with torch.no_grad(), tmodel.collect_stats() as stats:
            got = torch_form()
        assert tuple(got.shape) == tuple(want.shape), name
        _close(got.numpy(), want)
        if mode == "eval" or model == "transformer":
            assert stats == {} and (mode == "eval" or c.stats == {}), name
            continue
        # the statistics this call computes, from the stored (old) ones
        assert sorted(stats) == sorted(c.stats) == sorted(STATS), name
        for key, value in c.stats.items():
            np.testing.assert_allclose(stats[key].numpy(), np.asarray(value),
                                       atol=5e-6, rtol=0, err_msg=key)
    if model == "conve":
        # scoring writes no statistic of the model
        for key in STATS:
            np.testing.assert_array_equal(
                getattr(tmodel.get_scorer(), key).numpy(), params["scorer"][key])


@pytest.mark.parametrize("model", MODELS)
def test_eval_mode_factorizes_the_object_slot(model):
    """In eval mode both models factorize the object slot (ConvE's query
    is [1 | h], D = d + 1), and the product reproduces kge_tpu's score
    matrix; in train mode there is no factorization."""
    jmodel, params, tmodel = _pair(model)
    s, p, o = _queries(1)
    triples = torch.tensor(np.stack([s, p, o], axis=1))
    tmodel.eval()
    with torch.no_grad():
        fac = tmodel.factorized_queries(triples, (0, 2))
    dim = {"conve": 33, "transformer": 16}[model]
    for slot, want in ((2, jmodel.score_sp(params, s, p)),
                       (0, jmodel.score_po(params, p, o))):
        pos, q, targets, score_map = fac[slot]
        assert score_map is None and q.shape == (9, dim) and targets.shape == (7, dim)
        _close((q @ targets.T).detach().numpy(), want)
    tmodel.train()
    assert tmodel.factorized_queries(triples, (0, 2)) is None


@pytest.mark.parametrize("model", MODELS)
def test_optimizer_leaves_and_names_match_kge_tpu(model):
    """The port's optimizer holds kge_tpu's leaves in kge_tpu's order under
    kge_tpu's names (``_scorer.layers.0.in_proj_w``, ``_scorer.bn1_mean``),
    so that regex groups select the same leaves and states line up."""
    from kge_tpu.ops.optim import parameter_names
    from kge_tpu_torch.models import param_leaves
    from kge_tpu_torch.ops.optim import parameter_name

    _, params, tmodel = _pair(model)
    got = [parameter_name(path) for path, _ in param_leaves(tmodel)]
    assert got == parameter_names(params)
    assert [tuple(t.shape) for _, t in param_leaves(tmodel)] == [
        tuple(np.shape(leaf)) for leaf in jax.tree_util.tree_leaves(params)]
    assert "_scorer." + ("bn1_mean" if model == "conve"
                         else "layers.1.in_proj_w") in got
    assert tmodel.num_parameters() == sum(
        int(np.size(leaf)) for leaf in jax.tree_util.tree_leaves(params))
    # a regex group over the scorer labels the same leaves in both packages
    from kge_tpu.ops.optim import KgeOptimizer as JaxOptimizer
    from kge_tpu_torch.ops.optim import KgeOptimizer

    groups = {"train.optimizer.scorer.regex": ".*_scorer\\..*",
              "train.optimizer.scorer.args.lr": 0.01}
    labels = {}
    for package in (kge_tpu, kge_tpu_torch):
        config = make_config(package, "dataset_test",
                             {**neural_options(model), **groups})
        if package is kge_tpu:
            labels[package.__name__] = JaxOptimizer(config, params)._labels
        else:
            labels[package.__name__] = KgeOptimizer(config, param_leaves(tmodel))._labels
    assert labels["kge_tpu_torch"] == labels["kge_tpu"]
    assert labels["kge_tpu"].count(0) == len(jax.tree_util.tree_leaves(params["scorer"]))


# -- configuration and messages -------------------------------------------------------

CONFIG_CASES = {
    "conve_d32": ("conve", {"conve.entity_embedder.dim": 32,
                            "conve.relation_embedder.dim": 32}),
    "conve_round_dim": ("conve", {"conve.entity_embedder.dim": 30,
                                  "conve.relation_embedder.dim": 30,
                                  "conve.round_dim": True}),
    "conve_aspect_ratio": ("conve", {"conve.entity_embedder.dim": 30,
                                     "conve.relation_embedder.dim": 30}),
    "transformer_heads": ("transformer", {"transformer.entity_embedder.dim": 15,
                                          "transformer.relation_embedder.dim": 15,
                                          "transformer.encoder.nhead": 2}),
    "transformer_negative_dropout": ("transformer", {
        "transformer.entity_embedder.dim": 16,
        "transformer.relation_embedder.dim": 16,
        "transformer.encoder.dropout": -0.5}),
}


@pytest.mark.parametrize("case", sorted(CONFIG_CASES))
def test_configuration_matches_kge_tpu(case):
    """The model's options after creation (ConvE's embedders are d + 1 wide
    and the config keeps d, or the rounded d), or the same error."""
    model, options = CONFIG_CASES[case]
    outcome = {}
    for package in (kge_tpu, kge_tpu_torch):
        config = make_config(package, "dataset_test", {
            "model": model, **options, "job.auto_correct": True})
        dataset = package.Dataset.create(config, folder=str(DATASET_DIR))
        try:
            created = package.models.KgeModel.create(
                config, dataset, **({"device": "cpu"} if package is kge_tpu_torch
                                    else {}))
            scorer = created.get_scorer()
            outcome[package.__name__] = (
                config.get(f"{model}.entity_embedder.dim"),
                config.get(f"{model}.relation_embedder.dim"),
                created.get_s_embedder().dim, created.get_p_embedder().dim,
                getattr(scorer, "flat_size", None),
                getattr(scorer, "dropout", None),
            )
        except ValueError as e:
            outcome[package.__name__] = ("ValueError", str(e))
    assert outcome["kge_tpu_torch"] == outcome["kge_tpu"]


@pytest.mark.parametrize("call", ["spo_s", "spo_neg_s", "s_o", "_po"])
@pytest.mark.parametrize("model", MODELS)
def test_unsupported_slots_raise_as_in_kge_tpu(model, call):
    """Without the reciprocal wrapper both models score objects only, with
    kge_tpu's messages."""
    messages = {}
    s, p, o = (np.array([0, 1]), np.array([0, 1]), np.array([2, 3]))
    for package in (kge_tpu, kge_tpu_torch):
        options = {k: v for k, v in neural_options(model).items()
                   if not k.startswith("reciprocal")}
        config = make_config(package, "dataset_test", {**options, "model": model})
        dataset = package.Dataset.create(config, folder=str(DATASET_DIR))
        if package is kge_tpu:
            m = package.models.KgeModel.create(config, dataset)
            args = (m.init_params(jax.random.PRNGKey(0)),)
        else:
            m = package.models.KgeModel.create(config, dataset, device="cpu")
            m.init_params(torch.Generator().manual_seed(0))
            args, s, p, o = (), *(torch.tensor(a) for a in (s, p, o))
        try:
            if call == "spo_s":
                m.score_spo(*args, s, p, o, "s")
            elif call == "spo_neg_s":
                triples = np.stack([s, p, o], 1)
                m.score_spo_neg(*args, torch.tensor(triples) if not args else triples,
                                torch.tensor([[1], [2]]) if not args
                                else np.array([[1], [2]]), 0)
            elif call == "s_o":
                m.score_so(*args, s, o)
            else:
                m.score_po(*args, p, o)
            messages[package.__name__] = None
        except ValueError as e:
            messages[package.__name__] = str(e)
    assert messages["kge_tpu"] is not None
    assert messages["kge_tpu_torch"] == messages["kge_tpu"]


# -- training steps -------------------------------------------------------------------

ADAM_WD = {"train.optimizer.default.type": "Adam",
           "train.optimizer.default.args.lr": 0.001,
           "train.optimizer.default.args.weight_decay": 0.1}
ADAGRAD = {"train.optimizer.default.type": "Adagrad",
           "train.optimizer.default.args.lr": 0.1,
           "train.optimizer.default.args.initial_accumulator_value": 0.1}
STEP_CASES = {
    "1vsAll-adam-wd": {"train.type": "1vsAll", "train.loss": "kl", **ADAM_WD},
    "KvsAll-adagrad": {"train.type": "KvsAll", "train.loss": "bce",
                       "KvsAll.label_smoothing": 0.1, **ADAGRAD},
    "negsamp-o-adagrad": {"train.type": "negative_sampling", "train.loss": "kl",
                          "negative_sampling.implementation": "triple",
                          "negative_sampling.shared": False,
                          "negative_sampling.num_samples.s": 0,
                          "negative_sampling.num_samples.o": 4, **ADAGRAD},
}
SYNTH = "neural_synth"


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """64 entities, 8 relations, 300 training triples: batches of 32 (batch
    norm over 5 rows, all dataset_test offers, amplifies rounding past the
    tolerances below), the last one padded."""
    return make_synthetic_dataset(
        tmp_path_factory.mktemp("torch_neural") / SYNTH, num_entities=64,
        num_relations=8, num_train=300, num_valid=20, num_test=20, seed=7,
    )


def _nonzero_biases(jjob, tjob, seed=5):
    """Give the leaves that start at zero (the Transformer's biases) small
    random values in both jobs. The key bias of attention has a gradient
    that is zero up to rounding (softmax ignores a shift shared by a row's
    logits); at zero, weight decay adds nothing to it, and Adam would turn
    the rounding into steps of about +-lr (ROADMAP C.3)."""
    rng = np.random.default_rng(seed)

    def perturb(leaf):
        leaf = np.asarray(leaf)
        if leaf.any():
            return leaf
        return rng.normal(0.0, 0.02, leaf.shape).astype(np.float32)

    params = jax.tree_util.tree_map(perturb, jjob.model_params)
    jjob.model_params = jax.tree_util.tree_map(jnp.asarray, params)
    load_jax_params(tjob.model, params)


def _assert_same_state(jjob, tjob, paths):
    """Tables and scorer parameters within atol 5e-6; batch-norm statistics
    and optimizer state, sums of many rounded terms, within 5e-6 + 1e-5 of
    their leaf's largest magnitude (running variances reach about 60 and
    Adagrad's sums about 10^5, where float32's spacing alone passes 5e-6);
    the same step count."""

    def close(got, want, path, relative):
        want = np.asarray(want)
        atol = 5e-6 + (1e-5 * float(np.abs(want).max()) if relative else 0.0)
        np.testing.assert_allclose(got, want, atol=atol, rtol=0, err_msg=path)

    for path, got, want in zip(paths, torch_tables(tjob), jax_tables(jjob),
                               strict=True):
        close(got, want, path, path.split(".")[-1] in STATS)
    for path, got, want in zip(paths, tjob.opt_state["leaves"],
                               jjob.opt_state["leaves"], strict=True):
        assert sorted(got) == sorted(want), path
        for key in want:
            close(got[key].numpy(), want[key], f"{path}.{key}", True)
    assert int(tjob.opt_state["step"]) == int(jjob.opt_state["step"])


@pytest.mark.parametrize("case", sorted(STEP_CASES))
@pytest.mark.parametrize("model", MODELS)
def test_steps_match_kge_tpu(synth, model, case):
    """An epoch's steps from the same weights, the padded last batch
    included: the statistics are the last scoring call's of each step,
    written after the optimizer update; with weight decay Adam gives the
    statistics a state of their own, without it their state stays zero."""
    options = neural_options(model, **STEP_CASES[case], **{
        "valid.every": 0, "train.batch_size": 32})
    jjob, tjob = make_job_pair(synth, SYNTH, options)
    if model == "transformer":
        _nonzero_biases(jjob, tjob)
    paths = [".".join(map(str, path)) for path in tjob.optimizer._paths]
    assert len(jax_tables(jjob)) == len(paths)
    start = [t.copy() for t in torch_tables(tjob)]
    steps = len(list(tjob._batches()))
    if case.startswith("negsamp"):
        assert tjob._active_slots == [2]
        losses = run_steps(jjob, tjob, steps=steps)
    else:
        losses = run_batch_steps(jjob, tjob, steps=steps)
    assert any(b["true_size"] < b["mask"].shape[0] for b in tjob._batches())
    for want, got in losses:
        assert math.isfinite(got)
        np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_same_state(jjob, tjob, paths)
    moved = {path: float(np.abs(a - b).max())
             for path, a, b in zip(paths, torch_tables(tjob), start)}
    assert moved["entity_embedder.embeddings"] > 1e-3
    assert moved["scorer." + ("conv_w" if model == "conve" else "cls")] > 1e-3
    if model == "conve":
        for key in STATS:
            assert moved[f"scorer.{key}"] > 1e-3, key
            state = tjob.opt_state["leaves"][paths.index(f"scorer.{key}")]
            largest = max(float(v.abs().max()) for v in state.values())
            if "wd" in case:
                assert largest > 0, key
            elif "adagrad" in case:
                assert largest == np.float32(0.1), key  # the initial sum


# -- evaluation -----------------------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_eval_matches_kge_tpu(model):
    """Every metric of the trace entry equal, kge_tpu ranking its score
    matrix and the port the factorized queries through the rank kernel's
    plain version."""
    options = {"eval.split": "valid", "eval.batch_size": 2,
               "entity_ranking.filter_with_test": True,
               "entity_ranking.metrics_per.head_and_tail": True}
    jmodel, params, tmodel = _pair(model, seed=4, **options)
    jjob = JaxEvaluationJob.create(jmodel.config, jmodel.dataset, model=jmodel)
    jjob.model_params = params
    jjob.epoch = 0
    expected = jjob._evaluate()
    tjob = EvaluationJob.create(tmodel.config, tmodel.dataset, model=tmodel)
    tjob.epoch = 0
    tmodel.eval()
    with torch.inference_mode():
        got = tjob._evaluate()
    assert set(got) == set(expected)
    metrics = _metrics(expected)
    assert len(metrics) > 20
    assert _metrics(got) == metrics


# -- the command line -----------------------------------------------------------------


def test_toy_conve_example_trains_and_kge_tpu_resumes(tmp_path):
    """examples/toy-conve-train.yaml on the CPU: ten epochs, validations at
    5 and 10, checkpoints kept; kge_tpu resumes the folder for an epoch."""
    cwd = _toy_cwd(tmp_path)
    folder = cwd / "conve"
    _run([sys.executable, "-m", "kge_tpu_torch", "start",
          str(EXAMPLES_DIR / "toy-conve-train.yaml"), "--job.device", "cpu",
          "--folder", str(folder)], cwd=cwd)
    epochs = _entries(folder, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == list(range(1, 11))
    assert all(math.isfinite(e["avg_loss"]) for e in epochs)
    assert epochs[-1]["avg_loss"] < epochs[0]["avg_loss"]
    valid = _entries(folder, event="eval_completed")
    assert [e["epoch"] for e in valid] == [5, 10]
    assert all(0.0 < e["mean_reciprocal_rank_filtered"] <= 1.0 for e in valid)
    with open(folder / "config.yaml") as f:
        saved = yaml.safe_load(f)
    assert saved["lookup_embedder"]["dim"] == 32
    _run([sys.executable, "-m", "kge_tpu", "resume", str(folder),
          "--train.max_epochs", "11"], cwd=cwd)
    assert [e["epoch"] for e in _entries(folder, event="epoch_completed")][-1] == 11


CROSSING = {
    "conve": {"conve": {"entity_embedder": {"dim": 32},
                        "relation_embedder": {"dim": 32}},
              "train": {"type": "KvsAll"}},
    "transformer": {"import": ["transformer"],
                    "transformer": {"entity_embedder": {"dim": 16},
                                    "relation_embedder": {"dim": 16},
                                    "encoder": {"nhead": 2, "num_layers": 2,
                                                "dim_feedforward": 32}},
                    "train": {"type": "1vsAll"}},
}


@pytest.mark.parametrize("model", MODELS)
def test_checkpoints_cross_both_ways(tmp_path, model):
    """The port starts, kge_tpu resumes, the port resumes kge_tpu's
    checkpoint; Adam's state of every leaf (the statistics' included, in
    kge_tpu's positions) comes along, and ``test`` of either package
    reports the same metrics on the folder."""
    from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint

    conf = {
        "job": {"device": "cpu"},
        "dataset": {"name": str(DATASET_DIR)},
        "model": "reciprocal_relations_model",
        "reciprocal_relations_model": {"base_model": {"type": model}},
        "train": {"max_epochs": 2, "batch_size": 6,
                  "optimizer": {"default": {"type": "Adam", "args": {"lr": 0.003}}},
                  "checkpoint": {"every": 1}},
        "valid": {"every": 1, "metric": "mean_reciprocal_rank_filtered"},
        "entity_ranking": {"hits_at_k_s": [1, 3]},
        "console": {"quiet": True},
        "random_seed": {"default": 3},
    }
    for key, value in CROSSING[model].items():
        conf[key] = {**conf[key], **value} if key in conf else value
    (tmp_path / "toy.yaml").write_text(yaml.safe_dump(conf))
    folder = tmp_path / "exp"
    _run([sys.executable, "-m", "kge_tpu_torch", "start", str(tmp_path / "toy.yaml"),
          "--folder", str(folder)], cwd=tmp_path)
    saved = jax_load_checkpoint(str(folder / "checkpoint_00002.pt"))
    tree = saved["model"][0]
    leaves = jax.tree_util.tree_leaves(tree)
    assert len(saved["optimizer_state"]["leaves"]) == len(leaves)
    assert all(sorted(leaf) == ["m", "v"] for leaf in saved["optimizer_state"]["leaves"])
    if model == "conve":
        assert tree["entity_embedder"]["embeddings"].shape == (7, 33)
        assert sorted(tree["scorer"]) == sorted(
            ["conv_w", "conv_b", "proj_w", "proj_b", *STATS])
        assert np.abs(tree["scorer"]["bn1_mean"]).max() > 0
    else:
        assert len(tree["scorer"]["layers"]) == 2
    _run([sys.executable, "-m", "kge_tpu", "resume", str(folder),
          "--train.max_epochs", "3"], cwd=tmp_path)
    _run([sys.executable, "-m", "kge_tpu_torch", "resume", str(folder),
          "--job.device", "cpu", "--train.max_epochs", "4"], cwd=tmp_path)
    epochs = _entries(folder, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == [1, 2, 3, 4]
    assert all(math.isfinite(e["avg_loss"]) for e in epochs)
    last = jax_load_checkpoint(str(folder / "checkpoint_00004.pt"))
    assert int(last["optimizer_state"]["step"]) == 2 * int(
        saved["optimizer_state"]["step"])
    _run([sys.executable, "-m", "kge_tpu", "test", str(folder)], cwd=tmp_path)
    _run([sys.executable, "-m", "kge_tpu_torch", "test", str(folder),
          "--job.device", "cpu"], cwd=tmp_path)
    want, got = (_metrics(e) for e in _entries(
        folder, event="eval_completed", split="test"))
    assert 0.0 < want["mean_reciprocal_rank_filtered"] <= 1.0
    assert got == want
