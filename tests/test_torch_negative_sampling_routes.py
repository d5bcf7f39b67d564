"""The negative-sampling routes of per-row samples (``all``, ``batch``
without shared negatives, a pool drawn on the host) and the fused step
(``negative_sampling.fused_scoring: always``) of kge_tpu_torch against
kge_tpu on the CPU, and the per-row pick (``ops/pick.py``) against
``take_along_axis``.

Trajectories: five steps from the same weights, batches and injected
negatives (``tests/torch_parity.py`` ``run_steps``), kge_tpu in its CPU
form (flat score matrices and ``take_along_axis``). Losses rtol 1e-5,
tables atol 5e-6, optimizer state atol 1e-5. Adagrad starts from an
accumulator of 0.1: its first step is ``-lr * g / |g|``, the sign of g,
so a gradient element that cancels to about 0 (TransE-L1 against the whole
vocabulary meets the positive's own distance) would move a weight by lr in
one package and not in the other.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kge_tpu
import kge_tpu_torch
from kge_tpu.ops import pallas_ops
from kge_tpu_torch.ops import embedding_ops
from kge_tpu_torch.ops.pick import picked_scores
from tests.torch_parity import (
    assert_same_state,
    make_config,
    make_job_pair,
    per_row_negatives,
    pooled_options,
    run_steps,
    shared_negatives,
    torch_tables,
    train_options,
)
from tests.util import DATASET_DIR, make_synthetic_dataset

SYNTH = "routes_synth"


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    pallas_ops.set_gather_mode("xla")
    embedding_ops.set_gather_mode("torch")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    # 60 entities: a batch's 24 samples per slot are fewer than the
    # vocabulary, so the bounded unique pads with id 0
    return make_synthetic_dataset(tmp_path_factory.mktemp("routes") / SYNTH,
                                  num_entities=60, num_relations=5, num_train=96,
                                  seed=3)


# -- the pick ---------------------------------------------------------------------


@pytest.mark.parametrize("n,V,K", [(5, 7, 12), (16, 300, 128), (1, 3, 1)])
def test_picked_scores_equal_take_along_axis(n, V, K):
    """Values equal ``take_along_axis`` exactly; the gradient equals its VJP
    within float32 rounding, with columns picked several times in a row;
    two backward passes give the same bits."""
    rng = np.random.default_rng(n + V)
    S = rng.standard_normal((n, V)).astype(np.float32)
    idx = rng.integers(0, V, (n, K))
    idx[:, :3 if K >= 3 else K] = idx[:, :1]  # a column three times in a row
    g = rng.standard_normal((n, K)).astype(np.float32)

    want, vjp = jax.vjp(lambda s: jnp.take_along_axis(s, jnp.asarray(idx), axis=1),
                        jnp.asarray(S))
    (want_grad,) = vjp(jnp.asarray(g))

    grads = []
    for _ in range(2):
        St = torch.tensor(S, requires_grad=True)
        got = picked_scores(St, torch.tensor(idx))
        assert got.dtype == torch.float32 and got.shape == (n, K)
        np.testing.assert_array_equal(got.detach().numpy(), np.asarray(want))
        (grad,) = torch.autograd.grad(got, St, torch.tensor(g))
        grads.append(grad.numpy())
    np.testing.assert_allclose(grads[0], np.asarray(want_grad), rtol=1e-6, atol=1e-6)
    assert np.array_equal(grads[0], grads[1])


def test_bounded_unique_equals_jnp_unique():
    """``batch``'s dedup: kge_tpu's static-size unique, padded with id 0."""
    from kge_tpu_torch.job.train_negative_sampling import _bounded_unique

    rng = np.random.default_rng(0)
    for size, vocab in ((24, 60), (24, 7), (40, 1000)):
        ids = rng.integers(0, vocab, size)
        bound = min(size, vocab)
        want, want_inv = jnp.unique(jnp.asarray(ids), size=bound, fill_value=0,
                                    return_inverse=True)
        got, inv = _bounded_unique(torch.tensor(ids), bound)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
        np.testing.assert_array_equal(inv.numpy(), np.asarray(want_inv).reshape(-1))


# -- trajectories ---------------------------------------------------------------

ACC = {"train.optimizer.default.args.initial_accumulator_value": 0.1}
PER_ROW = {"negative_sampling.shared": False}
HOST_POOL = {"negative_sampling.implementation": "pool",
             "negative_sampling.on_device": "never"}
ROWS = {"train.sparse_embedding_update": "always"}
ADAM = {"train.optimizer.default.type": "Adam",
        "train.optimizer.default.args.lr": 0.01}

ROUTES = [
    # (name, model, options, sparse step)
    ("all-complex", "complex", {"negative_sampling.implementation": "all"}, False),
    ("all-transe", "transe", {"negative_sampling.implementation": "all"}, False),
    ("batch-complex", "complex", {"negative_sampling.implementation": "batch"}, False),
    ("batch-transe", "transe", {"negative_sampling.implementation": "batch"}, False),
    ("batch-complex-rows-adagrad", "complex",
     {"negative_sampling.implementation": "batch", **ROWS}, True),
    ("batch-complex-rows-adam", "complex",
     {"negative_sampling.implementation": "batch", **ROWS, **ADAM}, True),
    ("batch-transe-rows-adagrad", "transe",
     {"negative_sampling.implementation": "batch", **ROWS}, True),
    ("host_pool-complex", "complex", HOST_POOL, False),
    ("host_pool-transe", "transe", HOST_POOL, False),
    ("host_pool-complex-rows-adagrad", "complex", {**HOST_POOL, **ROWS}, True),
]


def _options(model, extra):
    if model == "transe":
        return pooled_options("transe", **ACC, **extra)
    return train_options(**PER_ROW, **ACC, **extra)


@pytest.mark.parametrize("dataset", ["dataset_test", SYNTH])
@pytest.mark.parametrize("name,model,extra,sparse", ROUTES,
                         ids=[r[0] for r in ROUTES])
def test_route_trajectory_matches_kge_tpu(synth, dataset, name, model, extra, sparse):
    where = (DATASET_DIR, "dataset_test") if dataset == "dataset_test" else (synth, SYNTH)
    jjob, tjob = make_job_pair(*where, _options(model, extra))
    assert tjob._implementation == jjob._implementation
    assert tjob._on_device == jjob._on_device
    assert tjob._sparse_update == jjob._sparse_update == sparse
    start = [t.copy() for t in torch_tables(tjob)]
    for want, got in run_steps(jjob, tjob):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_same_state(jjob, tjob)
    assert max(np.abs(a - b).max() for a, b in zip(torch_tables(tjob), start)) > 1e-3


def test_localized_batch_skips_the_unique(monkeypatch):
    """On the row-sparse step the per-row samples are localized to distinct
    mini-table positions and ``batch`` scores them as they are (kge_tpu's
    ``__localized__`` branch); the dense step deduplicates."""
    from kge_tpu_torch.job import train_negative_sampling as ns

    calls = []
    real = ns._bounded_unique
    monkeypatch.setattr(ns, "_bounded_unique",
                        lambda ids, size: calls.append(size) or real(ids, size))
    for sparse, expected in ((True, []), (False, [7, 7])):
        extra = {"negative_sampling.implementation": "batch"}
        if sparse:
            extra.update(ROWS)
        _, tjob = make_job_pair(DATASET_DIR, "dataset_test", _options("complex", extra))
        assert tjob._sparse_update == sparse
        batch = next(iter(tjob._batches()))
        triples = batch["triples"]
        arrays = {"triples": triples, "mask": batch["mask"],
                  **per_row_negatives(np.random.default_rng(0), triples, (0, 2), 4,
                                      [7, 3, 7])}
        calls.clear()
        tjob._train_step({k: torch.tensor(v) for k, v in arrays.items()},
                         tjob._current_lrs())
        assert calls == expected
        if sparse:
            local, ent_ids, _ = tjob._localize_batch(
                {k: torch.tensor(v) for k, v in arrays.items()})
            assert local["__localized__"] is True
            assert len(torch.unique(local["neg_samples_0"])) == 24


@pytest.mark.parametrize("sampling_type", ["uniform", "frequency"])
@pytest.mark.parametrize("route", ["native", "numpy"])
def test_filtered_negatives_train_epochs_as_kge_tpu(monkeypatch, route, sampling_type):
    """``filtering.o``: ``auto`` resolves to ``all`` in both packages, the
    host sampler draws the same filtered per-row samples, and whole epochs
    through ``run_epoch`` agree: with each package's native filter (the
    same draws) and with both libraries switched off (the same numpy
    passes), for uniform samples and for the frequency sampler's cdf."""
    from kge_tpu import native as jnative
    from kge_tpu_torch import native as tnative

    if route == "numpy":
        monkeypatch.setattr(jnative, "available", lambda: False)
        monkeypatch.setattr(tnative, "available", lambda: False)
    else:
        assert jnative.available() and tnative.available()
    options = _options("complex", {"negative_sampling.filtering.o": True,
                                   "negative_sampling.sampling_type": sampling_type})
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", options)
    assert tjob._implementation == jjob._implementation == "all"
    assert not tjob._on_device and not jjob._on_device
    calls = tnative.filter_resample.calls
    for epoch in (1, 2):
        jjob.epoch = tjob.epoch = epoch
        jentry = jjob.run_epoch()
        tentry = tjob.run_epoch()
        np.testing.assert_allclose(tentry["avg_loss"], jentry["avg_loss"], rtol=1e-4)
        assert set(jentry) - set(tentry) <= {"scanned"}
    assert_same_state(jjob, tjob)
    assert (tnative.filter_resample.calls > calls) == (route == "native")


# -- the fused step ---------------------------------------------------------------

FUSED = {"negative_sampling.fused_scoring": "always"}
FUSED_CASES = [
    ("shared", "complex", {}),
    ("batch", "complex", {**PER_ROW, "negative_sampling.implementation": "batch"}),
    ("pool", "complex", {**PER_ROW, "negative_sampling.implementation": "pool"}),
    ("triple", "complex", {**PER_ROW, "negative_sampling.implementation": "triple"}),
    ("pool", "transe", {}),
    ("shared-adam", "complex", ADAM),
]


@pytest.mark.parametrize("name,model,extra", FUSED_CASES,
                         ids=[f"{c[0]}-{c[1]}" for c in FUSED_CASES])
def test_fused_trajectory_matches_kge_tpu(name, model, extra):
    if model == "transe":
        options = pooled_options("transe", **ACC, **FUSED, **extra)
    else:
        options = train_options(**ACC, **FUSED, **extra)
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", options)
    assert tjob._fused and jjob._fused
    for want, got in run_steps(jjob, tjob):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_same_state(jjob, tjob)


@pytest.mark.parametrize("gather", ["always", "never"])
def test_fused_step_equals_unfused_step(gather):
    """The port's fused step and its unfused dense step from the same weights
    and negatives; with the scatter kernel's plain version the gathers of the
    two mini-tables write each table's gradient once."""
    jobs = []
    for fused in ("always", "never"):
        options = train_options(**ACC, **{"negative_sampling.fused_scoring": fused,
                                          "train.pallas_gather": gather,
                                          "lookup_embedder.regularize_weight": 0.01})
        jobs.append(make_job_pair(DATASET_DIR, "dataset_test", options)[1])
    assert jobs[0]._fused and not jobs[1]._fused
    batch = next(iter(jobs[0]._batches()))
    triples = batch["triples"]
    arrays = {"triples": triples, "mask": batch["mask"],
              **shared_negatives(np.random.default_rng(1), triples, (0, 2), 4, [7, 3, 7])}
    costs = []
    for job in jobs:
        cost, aux = job._train_step({k: torch.tensor(v) for k, v in arrays.items()},
                                    job._current_lrs())
        costs.append(float(cost))
        assert aux["penalties"]
    np.testing.assert_allclose(costs[0], costs[1], rtol=1e-6)
    for a, b in zip(torch_tables(jobs[0]), torch_tables(jobs[1])):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)


@pytest.mark.parametrize("case,extra", [
    ("all", {**PER_ROW, "negative_sampling.implementation": "all"}),
    ("reciprocal", {"model": "reciprocal_relations_model",
                    "reciprocal_relations_model.base_model.type": "complex"}),
    ("projection_embedder", {"model": "relational_tucker3",
                             "relational_tucker3.entity_embedder.dim": 8,
                             "relational_tucker3.relation_embedder.base_embedder.dim": 4}),
])
def test_fused_refusals_are_kge_tpus(case, extra):
    """kge_tpu's ValueError, message for message."""
    from kge_tpu.job import TrainingJob as JaxTrainingJob
    from kge_tpu_torch.job import TrainingJob

    options = train_options(**FUSED, **extra)
    errors = []
    for package, job_class in ((kge_tpu, JaxTrainingJob), (kge_tpu_torch, TrainingJob)):
        config = make_config(package, "dataset_test", options)
        job = job_class.create(config, package.Dataset.create(
            config, folder=str(DATASET_DIR)))
        with pytest.raises(ValueError) as error:
            job._prepare()
        errors.append(str(error.value))
    assert errors[0] == errors[1]
    assert "fused_scoring=always requires lookup embedders" in errors[1]


# -- the command line -------------------------------------------------------------


@pytest.mark.parametrize("args,implementation", [
    (["--negative_sampling.shared", "false",
      "--negative_sampling.implementation", "all"], "all"),
    (["--negative_sampling.shared", "false",
      "--negative_sampling.implementation", "batch"], "batch"),
    (["--negative_sampling.shared", "false", "--negative_sampling.implementation",
      "pool", "--negative_sampling.on_device", "never"], "pool"),
    (["--negative_sampling.shared", "false", "--negative_sampling.filtering.o",
      "true"], "all"),
    (["--negative_sampling.shared", "true",
      "--negative_sampling.fused_scoring", "always"], "batch"),
    (["--negative_sampling.shared", "true", "--train.subbatch_size", "2"], "batch"),
])
def test_routes_train_through_the_command_line(tmp_path, args, implementation):
    """The toy negative-sampling example with each route: the run exits 0,
    resolves the implementation as asked, validates at epochs 5 and 10 and
    its loss falls."""
    import sys

    import yaml

    from tests.test_torch_cli import EXAMPLES_DIR, _entries, _run, _toy_cwd

    cwd = _toy_cwd(tmp_path)
    folder = cwd / "run"
    _run([sys.executable, "-m", "kge_tpu_torch", "start",
          str(EXAMPLES_DIR / "toy-complex-train-negs.yaml"), "--job.device", "cpu",
          *args, "--folder", str(folder)], cwd=cwd)
    log = (folder / "kge.log").read_text()
    with open(folder / "config.yaml") as f:
        asked = yaml.safe_load(f)["negative_sampling"]["implementation"]
    assert asked == implementation or (
        asked == "auto" and f"Set negative_sampling.implementation={implementation}" in log)
    assert ("Using fused (localized single-gather) scoring" in log) == (
        "always" in args)
    epochs = _entries(folder, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == list(range(1, 11))
    assert epochs[-1]["avg_loss"] < epochs[0]["avg_loss"]
    assert [e["epoch"] for e in _entries(folder, event="eval_completed")] == [5, 10]
