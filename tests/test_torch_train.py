"""Training in kge_tpu_torch against kge_tpu on the CPU: toy trajectories on
tests/data/dataset_test (ComplEx d = 8, batch 6, shared negatives, Adagrad,
KL loss) from the same weights, the same batches and the same negatives,
injected as arrays (random streams of jax and torch cannot be compared).

Tolerances: per-step losses rtol 1e-5, tables atol 5e-6 and the Adagrad
``sum`` atol 1e-5 after five steps (kge_tpu's own dense-vs-sparse test
allows rtol 2e-4 on losses). Both packages evaluate the same float32
formulas; sums run in another order. What holds on this data: losses to
1.7e-7 relative, tables to 2.4e-7, ``sum`` to 2.9e-6, for the dense and the
row-sparse step alike. Adagrad's first step is ``-lr * g / (|g| + eps)``,
the sign of g, so the initial accumulator is set to 0.1 here: a gradient
element that cancels to ~0 would otherwise move its weight by lr in one
package and not in the other.
"""

import numpy as np
import pytest
import torch

import kge_tpu
import kge_tpu_torch
from kge_tpu.ops import pallas_ops
from kge_tpu_torch.ops import embedding_ops
from tests.torch_parity import (
    jax_tables as _jax_tables,
    make_config,
    make_job_pair,
    pooled_options,
    run_steps as _run_steps,
    shared_negatives,
    torch_tables as _tables,
    train_options,
)
from tests.util import DATASET_DIR, make_synthetic_dataset


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    pallas_ops.set_gather_mode("xla")
    embedding_ops.set_gather_mode("torch")


def _assert_same_state(jjob, tjob):
    for got, want in zip(_tables(tjob), _jax_tables(jjob)):
        np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
    for got, want in zip(tjob.opt_state["leaves"], jjob.opt_state["leaves"]):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=1e-5, rtol=0)
    assert int(tjob.opt_state["step"]) == int(jjob.opt_state["step"])


@pytest.mark.parametrize("gather", ["always", "never"])
@pytest.mark.parametrize("sparse", ["never", "always"])
def test_trajectory_matches_jax(sparse, gather):
    options = train_options(**{
        "train.sparse_embedding_update": sparse,
        "train.pallas_gather": gather,
        "train.optimizer.default.args.initial_accumulator_value": 0.1,
    })
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", options)
    assert tjob._sparse_update == jjob._sparse_update == (sparse == "always")
    assert embedding_ops.gather_mode() == (
        "kernel" if gather == "always" else "torch")
    start = [t.copy() for t in _tables(tjob)]
    losses = _run_steps(jjob, tjob)
    for want, got in losses:
        np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_same_state(jjob, tjob)
    assert any(np.abs(a - b).max() > 1e-3 for a, b in zip(_tables(tjob), start))


@pytest.mark.parametrize("case", ["p_negatives", "n3_weighted", "sgd_sparse",
                                  "naive_shared", "bce", "reciprocal",
                                  "pool", "pool_sparse", "triple",
                                  "triple_sparse"])
def test_trajectory_variants_match_jax(case):
    extra = {
        "p_negatives": {"negative_sampling.num_samples.p": 2,
                        "negative_sampling.num_samples.s": 2},
        "n3_weighted": {"lookup_embedder.regularize": "n3",
                        "lookup_embedder.space": "complex",
                        "lookup_embedder.regularize_weight": 0.05,
                        "complex.entity_embedder.regularize_args.weighted": True},
        "sgd_sparse": {"train.optimizer.default.type": "SGD",
                       "train.sparse_embedding_update": "always"},
        "naive_shared": {"negative_sampling.shared_type": "naive"},
        "bce": {"train.loss": "bce"},
        "reciprocal": {"model": "reciprocal_relations_model",
                       "reciprocal_relations_model.base_model.type": "complex"},
        # per-row negatives of a matmul scorer: the pool is scored once and
        # every row selects its columns; triple scores row by row
        "pool": {"negative_sampling.shared": False,
                 "negative_sampling.pool_factor": 3},
        "pool_sparse": {"negative_sampling.shared": False,
                        "negative_sampling.pool_factor": 3,
                        "negative_sampling.num_samples.p": 4,
                        "train.sparse_embedding_update": "always"},
        "triple": {"negative_sampling.shared": False,
                   "negative_sampling.implementation": "triple"},
        "triple_sparse": {"negative_sampling.shared": False,
                          "negative_sampling.implementation": "triple",
                          "train.sparse_embedding_update": "always"},
    }[case]
    options = train_options(**extra)
    if case != "sgd_sparse":
        options["train.optimizer.default.args.initial_accumulator_value"] = 0.1
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", options)
    assert tjob._sparse_update == jjob._sparse_update
    assert tjob._implementation == jjob._implementation
    for want, got in _run_steps(jjob, tjob):
        np.testing.assert_allclose(got, want, rtol=1e-4)
    _assert_same_state(jjob, tjob)


@pytest.mark.parametrize("case,implementation", [
    ("pool", "pool"), ("pool_sparse", "pool"), ("shared", "batch")])
def test_transe_l2_trajectory_matches_jax(case, implementation):
    """TransE-L2, margin ranking, Adagrad: five steps of pooled negatives
    on the dense and the row-sparse step and of shared negatives; both
    score their candidates once through the L2 factorization and its sqrt
    epilogue (every row picking its columns of the pool)."""
    extra = {"transe.l_norm": 2.0,
             "train.optimizer.default.args.initial_accumulator_value": 0.1}
    if case == "pool_sparse":
        extra["train.sparse_embedding_update"] = "always"
    if case == "shared":
        extra["negative_sampling.shared"] = True
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test",
                               pooled_options("transe", **extra))
    assert tjob._implementation == jjob._implementation == implementation
    assert tjob._sparse_update == jjob._sparse_update == (case == "pool_sparse")
    start = [t.copy() for t in _tables(tjob)]
    for want, got in _run_steps(jjob, tjob):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    _assert_same_state(jjob, tjob)
    assert max(np.abs(a - b).max() for a, b in zip(_tables(tjob), start)) > 1e-2


def test_sparse_step_equals_dense_step():
    """One job per step kind from the same weights and negatives: touched
    rows agree to atol 1e-6, rows that no batch named keep their bits."""
    jobs = {}
    for sparse in ("never", "always"):
        options = train_options(**{"train.sparse_embedding_update": sparse,
                                   "train.batch_size": 2})
        jobs[sparse] = make_job_pair(DATASET_DIR, "dataset_test", options)
    (jdense, dense), (jsparse, sparse) = jobs["never"], jobs["always"]
    start = [t.copy() for t in _tables(dense)]
    batch = next(iter(jdense._batches()))
    triples = batch["triples"].astype(np.int64)
    arrays = {"triples": triples, "mask": batch["mask"]}
    arrays.update(shared_negatives(np.random.default_rng(0), triples, (0, 2), 4,
                                   [7, 3, 7]))
    for job in (dense, sparse):
        job._train_step({k: torch.tensor(v) for k, v in arrays.items()},
                        job._current_lrs())
    touched = np.unique(np.concatenate(
        [triples[:, 0], triples[:, 2], arrays["neg_unique_0"],
         arrays["neg_unique_2"]]))
    untouched = np.setdiff1d(np.arange(7), touched)
    assert len(untouched) > 0
    for a, b in zip(_tables(dense), _tables(sparse)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert np.array_equal(_tables(sparse)[0][untouched], start[0][untouched])
    assert np.array_equal(_tables(dense)[0][untouched], start[0][untouched])


def test_host_sampler_epochs_match_jax():
    """``on_device: never``: both packages draw the same shared negatives
    from the same host sampler and shuffle alike, so whole epochs through
    ``run_epoch`` agree."""
    options = train_options(**{
        "negative_sampling.on_device": "never",
        "train.optimizer.default.args.initial_accumulator_value": 0.1,
    })
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", options)
    for epoch in (1, 2):
        jjob.epoch = tjob.epoch = epoch
        jentry = jjob.run_epoch()
        tentry = tjob.run_epoch()
        np.testing.assert_allclose(tentry["avg_loss"], jentry["avg_loss"], rtol=1e-4)
        for key in ("batches", "size", "type", "scope", "split", "event",
                    "num_parameters", "avg_penalties"):
            assert tentry[key] == jentry[key], key
        assert set(jentry) - set(tentry) <= {"scanned"}
    _assert_same_state(jjob, tjob)


def test_shuffles_match_jax():
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", train_options())
    for _ in range(2):
        np.testing.assert_array_equal(tjob._epoch_permutation(12),
                                      jjob._epoch_permutation(12))
    jbatches = list(jjob._batches())
    tbatches = list(tjob._batches())
    assert len(jbatches) == len(tbatches) == 2
    for jb, tb in zip(jbatches, tbatches):
        np.testing.assert_array_equal(tb["triples"], jb["triples"])
        np.testing.assert_array_equal(tb["mask"], jb["mask"])
        assert tb["true_size"] == jb["true_size"]


# -- which step engages ---------------------------------------------------------

ELIGIBILITY = [
    ("never", {"train.sparse_embedding_update": "never"}),
    ("always", {"train.sparse_embedding_update": "always"}),
    ("auto_small_vocab", {}),
    ("reciprocal", {"train.sparse_embedding_update": "always",
                    "model": "reciprocal_relations_model",
                    "reciprocal_relations_model.base_model.type": "complex"}),
    ("normalize", {"train.sparse_embedding_update": "always",
                   "lookup_embedder.normalize.p": 2.0}),
    ("table_penalty", {"train.sparse_embedding_update": "always",
                       "lookup_embedder.regularize_weight": 0.1}),
    ("weighted_penalty", {"train.sparse_embedding_update": "always",
                          "lookup_embedder.regularize_weight": 0.1,
                          "complex.entity_embedder.regularize_args.weighted": True,
                          "complex.relation_embedder.regularize_weight": 0.0}),
    ("sgd", {
        "train.sparse_embedding_update": "always",
        "train.optimizer.default.type": "SGD",
        "train.optimizer.default.args.lr": 0.1}),
]


@pytest.mark.parametrize("name,extra", ELIGIBILITY)
def test_sparse_update_engages_as_in_jax(name, extra):
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", train_options(**extra))
    assert tjob._sparse_update == jjob._sparse_update, name
    assert tjob._implementation == jjob._implementation == "batch"
    assert tjob._on_device == jjob._on_device


def test_auto_engages_at_large_vocabulary(tmp_path):
    """``auto`` wants num_entities >= 8 x the rows a batch touches: with
    batch 2 and one shared negative per slot that is 8 x (4 + 2 x 2) = 64."""
    for entities, expected in ((64, True), (63, False)):
        folder = make_synthetic_dataset(tmp_path / f"syn{entities}",
                                        num_entities=entities, num_train=128)
        options = train_options(**{"train.batch_size": 2,
                                   "negative_sampling.num_samples.s": 1})
        jjob, tjob = make_job_pair(folder, folder.name, options)
        assert tjob._sparse_update == jjob._sparse_update == expected
        losses = _run_steps(jjob, tjob, steps=2)
        for want, got in losses:
            np.testing.assert_allclose(got, want, rtol=1e-4)


def _torch_job(extra):
    from kge_tpu_torch.job import TrainingJob

    config = make_config(kge_tpu_torch, "dataset_test", train_options(**extra))
    dataset = kge_tpu_torch.Dataset.create(config, folder=str(DATASET_DIR))
    return TrainingJob.create(config, dataset)


def test_rules_without_fixed_points_name_the_missing_kernel(tmp_path):
    """Zero-gradient rows are no fixed points of Adam, so the row-sparse step
    gives both tables the fused dense-semantics update, as kge_tpu does: the
    job's log names it, and a step moves rows that the batch did not touch
    (their moments decay) exactly as the dense step does."""
    extra = {"train.optimizer.default.type": "Adam",
             "train.optimizer.default.args.lr": 0.01, "train.batch_size": 2}
    jobs = {}
    for sparse in ("never", "always"):
        job = _torch_job({**extra, "train.sparse_embedding_update": sparse})
        job.config.folder = str(tmp_path / sparse)
        job.config.init_folder()
        job.config.set("console.quiet", True)
        job._prepare()
        job._is_prepared = True
        jobs[sparse] = job
    dense, sparse = jobs["never"], jobs["always"]
    assert sparse._sparse_update and not dense._sparse_update
    with open(tmp_path / "always" / "kge.log") as f:
        assert "fused dense-semantics kernel" in f.read()
    for step in range(2):
        batch = list(dense._batches())[step]
        triples = batch["triples"]
        arrays = {"triples": triples, "mask": batch["mask"]}
        arrays.update(shared_negatives(np.random.default_rng(step), triples,
                                       (0, 2), 4, [7, 3, 7]))
        for job in (dense, sparse):
            job._train_step({k: torch.tensor(v) for k, v in arrays.items()},
                            job._current_lrs())
    # lr 0.01: a step moves an element by about lr, the two steps agree far
    # below that (sums of a row's gradients run in another order)
    for a, b in zip(_tables(dense), _tables(sparse)):
        np.testing.assert_allclose(a, b, atol=2e-5, rtol=0)
    for a, b in zip(dense.opt_state["leaves"], sparse.opt_state["leaves"]):
        assert sorted(a) == sorted(b) == ["m", "v"]
        for key in a:
            np.testing.assert_allclose(a[key].numpy(), b[key].numpy(), atol=1e-6)


@pytest.mark.parametrize("extra,resolved,ported", [
    ({"negative_sampling.shared": False}, "pool", True),
    ({"negative_sampling.shared": False, "negative_sampling.on_device": "never"},
     "all", False),
    ({"negative_sampling.shared": False, "negative_sampling.auto_exact": True,
      "train.sparse_embedding_update": "always"}, "triple", True),
    ({"negative_sampling.implementation": "triple"}, "triple", True),
    ({"negative_sampling.shared": False,
      "negative_sampling.implementation": "batch"}, "batch", False),
    ({"negative_sampling.shared": False, "negative_sampling.on_device": "never",
      "negative_sampling.implementation": "pool"}, "pool", False),
    ({"negative_sampling.shared": False,
      "negative_sampling.filtering.o": True}, "all", False),
])
def test_unported_implementations_raise(extra, resolved, ported):
    """The ``auto`` ladder resolves as kge_tpu's does; what it resolves to
    raises when it is not ported (``all``, ``batch`` without shared
    negatives, a pool drawn on the host) and prepares when it is."""
    from kge_tpu.job import TrainingJob as JaxTrainingJob

    jconfig = make_config(kge_tpu, "dataset_test", train_options(**extra))
    jconfig.set("parallel.data", 1)
    jconfig.set("parallel.model", 1)
    jjob = JaxTrainingJob.create(
        jconfig, kge_tpu.Dataset.create(jconfig, folder=str(DATASET_DIR)))
    jjob._prepare()
    assert jjob._implementation == resolved
    job = _torch_job(extra)
    if ported:
        job._prepare()
        assert job._implementation == resolved
        assert job._on_device == jjob._on_device
    else:
        with pytest.raises(NotImplementedError, match="ROADMAP"):
            job._prepare()
    assert job.config.get("negative_sampling.implementation") == resolved


@pytest.mark.parametrize("extra,error", [
    ({"negative_sampling.implementation": "pool"}, "shared negatives"),
    ({"negative_sampling.implementation": "pool",
      "negative_sampling.shared": False,
      "negative_sampling.filtering.s": True}, "cannot filter"),
    ({"negative_sampling.implementation": "pool",
      "negative_sampling.shared": False,
      "negative_sampling.pool_factor": 0}, "pool_factor"),
])
def test_pool_refusals_are_kge_tpus(extra, error):
    from kge_tpu.job import TrainingJob as JaxTrainingJob

    jconfig = make_config(kge_tpu, "dataset_test", train_options(**extra))
    jjob = JaxTrainingJob.create(
        jconfig, kge_tpu.Dataset.create(jconfig, folder=str(DATASET_DIR)))
    with pytest.raises(ValueError, match=error):
        jjob._prepare()
    with pytest.raises(ValueError, match=error):
        _torch_job(extra)._prepare()


@pytest.mark.parametrize("extra,error", [
    ({"negative_sampling.fused_scoring": "always"}, NotImplementedError),
    ({"train.subbatch_size": 3}, NotImplementedError),
    ({"negative_sampling.on_device": "sometimes"}, ValueError),
    ({"train.pallas_gather": "maybe"}, ValueError),
    ({"train.sparse_embedding_update": "yes"}, ValueError),
])
def test_unported_options_raise(extra, error):
    with pytest.raises(error):
        _torch_job(extra)._prepare()


# -- negatives drawn on the device ----------------------------------------------


@pytest.mark.parametrize("sampling_type", ["uniform", "frequency"])
def test_negatives_drawn_on_device(sampling_type):
    job = _torch_job({"negative_sampling.sampling_type": sampling_type,
                      "negative_sampling.num_samples.s": 5})
    job._prepare()
    triples = torch.tensor(job.dataset.split("train")[:6].astype(np.int64))
    drawn = job._draw_negatives_on_device(triples, 0)
    sample = drawn["neg_unique_0"]
    assert sample.shape == (6,) and int(sample.min()) >= 0 and int(sample.max()) < 7
    matches = sample[None, :5] == triples[:, 0][:, None]
    assert torch.equal(drawn["neg_hasmatch_0"], matches.any(dim=1))
    for i in range(6):
        if bool(matches[i].any()):
            assert int(drawn["neg_first_0"][i]) == int(torch.nonzero(matches[i])[0])
    # the same seed draws the same negatives
    again = _torch_job({"negative_sampling.sampling_type": sampling_type,
                        "negative_sampling.num_samples.s": 5})
    again._prepare()
    assert torch.equal(again._draw_negatives_on_device(triples, 0)["neg_unique_0"],
                       sample)
    # the spare replaces each row's own positive
    scores = torch.arange(36, dtype=torch.float32).reshape(6, 6)
    neg = job._neg_from_unique_scores(scores, drawn, 0, 5)
    for i in range(6):
        row = scores[i, :5].clone()
        if bool(matches[i].any()):
            row[int(drawn["neg_first_0"][i])] = scores[i, 5]
        assert torch.equal(neg[i], row)


def test_training_learns_and_dropout_acts_in_train_mode_only():
    job = _torch_job({"lookup_embedder.dropout": 0.5, "train.max_epochs": 3})
    job._prepare()
    job._is_prepared = True
    embedder = job.model.get_s_embedder()
    ids = torch.arange(7)
    job.model.train()
    dropped = embedder.embed(ids)
    assert float((dropped == 0).float().mean()) > 0.2
    kept = dropped != 0
    torch.testing.assert_close(dropped[kept], (embedder.embeddings * 2)[kept])
    job.model.eval()
    assert torch.equal(embedder.embed(ids), embedder.embeddings)
    losses = []
    for epoch in (1, 2, 3, 4):
        job.epoch = epoch
        losses.append(job.run_epoch()["avg_loss"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("sparse", ["never", "always"])
def test_per_slot_scoring_equals_embed_once_scoring(sparse, monkeypatch):
    """With embedder dropout the job scores slot by slot (one dropout draw
    per scoring call, as kge_tpu); without dropout that path gives the
    embed-once path's losses and tables, on the dense step and on the
    mini-tables of the row-sparse step."""
    results = []
    for per_slot in (False, True):
        job = _torch_job({"train.sparse_embedding_update": sparse,
                          "negative_sampling.num_samples.p": 2})
        job._prepare()
        if per_slot:
            monkeypatch.setattr(job, "_grouped_multi_eligible", lambda: False)
        rng = np.random.default_rng(9)
        losses = []
        for batch in job._batches():
            triples = batch["triples"]
            arrays = {"triples": triples, "mask": batch["mask"]}
            arrays.update(shared_negatives(rng, triples, (0, 1, 2), 4, [7, 3, 7]))
            # the p slot draws 2 negatives and a spare
            for key in ("neg_unique_1", "neg_first_1", "neg_hasmatch_1"):
                del arrays[key]
            arrays.update(shared_negatives(rng, triples, (1,), 2, [7, 3, 7]))
            _, aux = job._train_step({k: torch.tensor(v) for k, v in arrays.items()},
                                     job._current_lrs())
            losses.append(float(aux["avg_loss"]))
        results.append((losses, _tables(job)))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-5)
    for a, b in zip(results[1][1], results[0][1]):
        np.testing.assert_allclose(a, b, atol=1e-6)


def test_profile_option_writes_a_trace(tmp_path):
    job = _torch_job({"train.profile": True})
    job.config.folder = str(tmp_path / "exp")
    job.config.init_folder()
    job.epoch = 1
    entry = job.run_epoch()
    assert entry["batches"] == 2
    assert (tmp_path / "exp" / "profile" / "epoch_00001.json").is_file()


@pytest.mark.parametrize("model", ["complex", "reciprocal_relations_model",
                                   "transe", "rotate", "transh"])
def test_every_ported_model_has_a_ranking_route(model):
    from kge_tpu_torch.job.eval_entity_ranking import has_ranking_route

    config = make_config(kge_tpu_torch, "dataset_test",
                         {"model": model, "lookup_embedder.dim": 8,
                          "reciprocal_relations_model.base_model.type": "transe"})
    dataset = kge_tpu_torch.Dataset.create(config, folder=str(DATASET_DIR))
    assert has_ranking_route(kge_tpu_torch.models.KgeModel.create(config, dataset))


def test_validation_without_a_ranking_route_is_refused_at_creation():
    """A run whose validation could not evaluate its model is refused when
    the job is created, before any epoch, unless it does not validate."""
    from kge_tpu_torch.job import TrainingJob

    for every in (1, 0):
        config = make_config(kge_tpu_torch, "dataset_test",
                             train_options(**{"valid.every": every}))
        dataset = kge_tpu_torch.Dataset.create(config, folder=str(DATASET_DIR))
        model = kge_tpu_torch.models.KgeModel.create(config, dataset)
        model._scorer = torch.nn.Identity()  # no relational scorer
        if every:
            with pytest.raises(ValueError, match="no entity-ranking route"):
                TrainingJob.create(config, dataset, model=model)
        else:
            TrainingJob.create(config, dataset, model=model)
