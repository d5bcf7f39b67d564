"""1vsAll and KvsAll training of kge_tpu_torch against kge_tpu on the CPU,
on tests/data/dataset_test and a seeded synthetic graph (64 entities, 8
relations): the same batches (array for array, two epochs), five-step
trajectories through both jobs' raw steps from the same weights, two whole
epochs through ``run_epoch`` (kge_tpu with ``train.epoch_scan: never``, the
order the port runs), label-smoothing checks and refusals, and checkpoints
that cross both ways through the command line.

Tolerances as in test_torch_train.py: losses rtol 1e-5, tables atol 5e-6,
Adagrad's ``sum`` atol 1e-5 (initial accumulator 0.1, so that a gradient
element that cancels to about 0 moves no weight by lr in one package and
not in the other); epoch losses rtol 1e-4.
"""

import importlib
import math
import sys

import numpy as np
import pytest
import torch
import yaml

import kge_tpu
import kge_tpu_torch
from kge_tpu.ops import pallas_ops
from kge_tpu_torch.ops import embedding_ops
from tests.test_torch_cli import EXAMPLES_DIR, _entries, _metrics, _run, _toy_cwd
from tests.torch_parity import (
    assert_same_state,
    make_config,
    make_job_pair,
    run_batch_steps,
    torch_tables,
)
from tests.util import DATASET_DIR, make_synthetic_dataset

SYNTH = "kvsall_synth"

#: KvsAll query-type sets: name -> options
QUERY_TYPES = {
    "sp_po": {"KvsAll.query_types.sp_": True, "KvsAll.query_types.s_o": False,
              "KvsAll.query_types._po": True},
    "s_o": {"KvsAll.query_types.sp_": False, "KvsAll.query_types.s_o": True,
            "KvsAll.query_types._po": False},
    "all": {"KvsAll.query_types.sp_": True, "KvsAll.query_types.s_o": True,
            "KvsAll.query_types._po": True},
}


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    pallas_ops.set_gather_mode("xla")
    embedding_ops.set_gather_mode("torch")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(
        tmp_path_factory.mktemp("torch_kvsall") / SYNTH, num_entities=64,
        num_relations=8, num_train=512, num_valid=32, num_test=32, seed=7,
    )


def options(train_type, **extra):
    """A toy ComplEx job (d = 8, KL loss, Adagrad lr 0.1 with initial
    accumulator 0.1, batch 6 for dataset_test)."""
    out = {
        "model": "complex",
        "lookup_embedder.dim": 8,
        "train.type": train_type,
        "train.batch_size": 6,
        "train.loss": "kl",
        "train.optimizer.default.type": "Adagrad",
        "train.optimizer.default.args.lr": 0.1,
        "train.optimizer.default.args.initial_accumulator_value": 0.1,
        "valid.every": 0,
    }
    out.update(extra)
    return out


def _where(synth, dataset):
    return (DATASET_DIR, "dataset_test") if dataset == "dataset_test" else (synth, SYNTH)


# -- batches ----------------------------------------------------------------------


@pytest.mark.parametrize("dataset", ["dataset_test", SYNTH])
@pytest.mark.parametrize("case", ["1vsAll", "sp_po", "s_o", "all"])
def test_batches_match_kge_tpu(synth, dataset, case):
    """Two epochs of batches equal kge_tpu's array for array: the same
    shuffles from the same generator, drawn in the same order."""
    if case == "1vsAll":
        opts = options("1vsAll")
    else:
        opts = options("KvsAll", **QUERY_TYPES[case])
    if dataset == SYNTH:
        opts["train.batch_size"] = 32
    jjob, tjob = make_job_pair(*_where(synth, dataset), opts)
    assert tjob.num_examples == jjob.num_examples
    for _ in range(2):
        jbatches, tbatches = list(jjob._batches()), list(tjob._batches())
        assert len(tbatches) == len(jbatches) > 1
        for jb, tb in zip(jbatches, tbatches):
            assert sorted(tb) == sorted(jb)
            for key, want in jb.items():
                if isinstance(want, np.ndarray):
                    assert tb[key].dtype == want.dtype, key
                    np.testing.assert_array_equal(tb[key], want, err_msg=key)
                else:
                    assert tb[key] == want, key
            assert tjob._step_variant(tb) == jjob._step_variant(jb)
    if case != "1vsAll":
        seen = {jjob._step_variant(b) for b in jbatches}
        assert seen == set(jjob.query_types) == set(tjob.query_types)


def test_dense_labels_sum_to_the_csr_counts(synth):
    """A batch's dense label rows sum to the number of distinct answers of
    each query (a triple that the split holds twice sets its label once),
    padded coordinates dropped."""
    _, tjob = make_job_pair(synth, SYNTH, options(
        "KvsAll", **{**QUERY_TYPES["all"], "train.batch_size": 32}))
    for batch in tjob._batches():
        qtype = tjob._step_variant(batch)
        index = tjob.query_indexes[qtype]
        device_batch = {k: torch.as_tensor(v) for k, v in batch.items()
                        if k != "true_size" and not isinstance(v, str)}
        labels = tjob._dense_labels(device_batch, qtype)
        assert labels.shape == (32, tjob._vocab_size(qtype))
        n = batch["true_size"]
        counts = [len(np.unique(index.get(*key))) for key in batch["queries"][:n]]
        np.testing.assert_array_equal(labels.sum(1).numpy()[:n], counts)
        assert float(labels[n:].sum()) == 0.0
        assert set(np.unique(labels.numpy())) <= {0.0, 1.0}


# -- trajectories -----------------------------------------------------------------


@pytest.mark.parametrize("model", ["complex", "reciprocal_complex"])
@pytest.mark.parametrize("loss", ["kl", "ce", "bce"])
def test_1vsall_trajectory_matches_kge_tpu(model, loss):
    extra = {"train.loss": loss}
    if model == "reciprocal_complex":
        extra.update({"model": "reciprocal_relations_model",
                      "reciprocal_relations_model.base_model.type": "complex"})
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", options("1vsAll", **extra))
    start = [t.copy() for t in torch_tables(tjob)]
    for want, got in run_batch_steps(jjob, tjob):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_same_state(jjob, tjob)
    assert max(np.abs(a - b).max() for a, b in zip(torch_tables(tjob), start)) > 1e-2


@pytest.mark.parametrize("gather", ["always", "never"])
@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("query_types", ["sp_po", "s_o"])
def test_kvsall_trajectory_matches_kge_tpu(synth, query_types, label_smoothing,
                                           gather):
    opts = options("KvsAll", **QUERY_TYPES[query_types], **{
        "KvsAll.label_smoothing": label_smoothing,
        "train.pallas_gather": gather,
        "train.batch_size": 32,
    })
    jjob, tjob = make_job_pair(synth, SYNTH, opts)
    assert tjob.label_smoothing == jjob.label_smoothing == label_smoothing
    assert embedding_ops.gather_mode() == ("kernel" if gather == "always" else "torch")
    start = [t.copy() for t in torch_tables(tjob)]
    for want, got in run_batch_steps(jjob, tjob):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_same_state(jjob, tjob)
    assert max(np.abs(a - b).max() for a, b in zip(torch_tables(tjob), start)) > 1e-2


@pytest.mark.parametrize("train_type", ["1vsAll", "KvsAll"])
def test_epochs_match_kge_tpu(synth, train_type):
    """Two epochs through ``run_epoch``: kge_tpu without its scanned epoch
    (which shuffles 1vsAll inside the scan and groups KvsAll's batches by
    query type) runs the port's order, so the trace entries agree."""
    opts = options(train_type, **{"train.epoch_scan": "never",
                                  "train.batch_size": 32})
    if train_type == "KvsAll":
        opts.update(QUERY_TYPES["all"])
    jjob, tjob = make_job_pair(synth, SYNTH, opts)
    for epoch in (1, 2):
        jjob.epoch = tjob.epoch = epoch
        jentry = jjob.run_epoch()
        tentry = tjob.run_epoch()
        assert math.isfinite(tentry["avg_loss"])
        np.testing.assert_allclose(tentry["avg_loss"], jentry["avg_loss"], rtol=1e-4)
        np.testing.assert_allclose(tentry["avg_cost"], jentry["avg_cost"], rtol=1e-4)
        for key in ("batches", "size", "type", "scope", "split", "event",
                    "num_parameters", "avg_penalties", "epoch"):
            assert tentry[key] == jentry[key], key
        assert set(jentry) - {"scanned"} == set(tentry)
    assert_same_state(jjob, tjob)


# -- checks and refusals ------------------------------------------------------------


@pytest.mark.parametrize("label_smoothing,auto_correct", [
    (0.0, False), (0.5, False), (-0.2, True), (-0.2, False), (0.001, True),
    (0.001, False), (1.0 / 64, True), (1.0, True),
])
def test_label_smoothing_checks_match_kge_tpu(synth, label_smoothing, auto_correct):
    """Errors and auto-corrections as kge_tpu's: below 0 becomes 0, at most
    1/num_entities becomes 1/num_entities, 1 or more is out of range."""
    outcome = {}
    for package in (kge_tpu, kge_tpu_torch):
        config = make_config(package, SYNTH, options("KvsAll", **{
            "KvsAll.label_smoothing": label_smoothing,
            "job.auto_correct": auto_correct,
        }))
        dataset = package.Dataset.create(config, folder=str(synth))
        try:
            training_job = importlib.import_module(package.__name__ + ".job").TrainingJob
            job = training_job.create(config, dataset)
            outcome[package.__name__] = ("value", job.label_smoothing)
        except Exception as e:  # noqa: BLE001 - the exception is compared
            outcome[package.__name__] = (type(e).__name__, str(e))
    assert outcome["kge_tpu_torch"] == outcome["kge_tpu"]


@pytest.mark.parametrize("case", ["no_query_type", "reciprocal_s_o"])
def test_refusals_match_kge_tpu(synth, case):
    """No enabled query type refuses the job; the reciprocal relations
    model cannot score relations (``s_o``)."""
    from kge_tpu_torch.job import TrainingJob

    if case == "no_query_type":
        opts = options("KvsAll", **{f"KvsAll.query_types.{q}": False
                                    for q in ("sp_", "s_o", "_po")})
        with pytest.raises(ValueError, match="at least one enabled query type"):
            make_job_pair(synth, SYNTH, opts)
        config = make_config(kge_tpu_torch, SYNTH, opts)
        job = TrainingJob.create(
            config, kge_tpu_torch.Dataset.create(config, folder=str(synth)))
        with pytest.raises(ValueError, match="at least one enabled query type"):
            job._prepare()
        return
    opts = options("KvsAll", **QUERY_TYPES["s_o"], **{
        "model": "reciprocal_relations_model",
        "reciprocal_relations_model.base_model.type": "complex",
        "train.batch_size": 32,
    })
    jjob, tjob = make_job_pair(synth, SYNTH, opts)
    with pytest.raises(ValueError, match="cannot score relations"):
        run_batch_steps(jjob, tjob, steps=1)
    batch = next(iter(tjob._batches()))
    with pytest.raises(ValueError, match="cannot score relations"):
        tjob._train_step({k: torch.as_tensor(v) for k, v in batch.items()
                          if k != "true_size" and not isinstance(v, str)},
                         tjob._current_lrs(), "s_o")


# -- the command line ---------------------------------------------------------------

SHORT_1VSALL = ["--dataset.name", "dataset_test", "--lookup_embedder.dim", "8",
                "--train.max_epochs", "2", "--valid.every", "1"]


@pytest.mark.parametrize("example,extra,validated", [
    pytest.param("toy-complex-train.yaml", [], [5, 10], id="toy-complex"),
    pytest.param("toy-rt3-train.yaml", [], [5, 10], id="toy-rt3"),
    pytest.param("fb15k-237-complex-1vsall.yaml", SHORT_1VSALL, [1, 2],
                 id="fb15k-237-1vsall"),
])
def test_examples_train_and_validate(tmp_path, example, extra, validated):
    """The KvsAll examples and the FB15k-237 1vsAll example (on the toy
    dataset, cut to two epochs) train on the CPU, validate on schedule and
    keep their checkpoints."""
    folder = tmp_path / "exp"
    _run([sys.executable, "-m", "kge_tpu_torch", "start", str(EXAMPLES_DIR / example),
          "--job.device", "cpu", "--folder", str(folder), *extra], cwd=_toy_cwd(tmp_path))
    epochs = _entries(folder, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == list(range(1, validated[-1] + 1))
    assert all(math.isfinite(e["avg_loss"]) for e in epochs)
    assert epochs[-1]["avg_loss"] < epochs[0]["avg_loss"]
    valid = _entries(folder, event="eval_completed")
    assert [e["epoch"] for e in valid] == validated
    assert all(0.0 < e["mean_reciprocal_rank_filtered"] <= 1.0 for e in valid)
    last = f"checkpoint_{validated[-1]:05d}.pt"
    assert {"checkpoint_00000.pt", last, "checkpoint_best.pt"} <= {
        p.name for p in folder.glob("checkpoint_*.pt")}


# -- checkpoints across the packages ------------------------------------------------

CROSSING = {
    "rt3_kvsall": {
        "model": "relational_tucker3",
        "relational_tucker3": {"entity_embedder": {"dim": 8},
                               "relation_embedder": {"base_embedder": {"dim": 4}}},
        "train": {"type": "KvsAll"},
    },
    "reciprocal_complex_1vsall": {
        "model": "reciprocal_relations_model",
        "reciprocal_relations_model": {"base_model": {"type": "complex"}},
        "lookup_embedder": {"dim": 8, "regularize": "n3",
                            "regularize_weight": 1.0e-3},
        "train": {"type": "1vsAll"},
    },
}


@pytest.mark.parametrize("case", sorted(CROSSING))
def test_checkpoints_cross_both_ways(tmp_path, case):
    """The port starts, kge_tpu resumes, the port resumes kge_tpu's
    checkpoint; the optimizer state comes along each time, and ``test`` of
    either package reports the same metrics on the folder."""
    from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint

    conf = {
        "job": {"device": "cpu"},
        "dataset": {"name": str(DATASET_DIR)},
        "train": {"max_epochs": 2, "batch_size": 6,
                  "optimizer": {"default": {"type": "Adagrad", "args": {"lr": 0.2}}},
                  "checkpoint": {"every": 1}},
        "valid": {"every": 1, "metric": "mean_reciprocal_rank_filtered"},
        "entity_ranking": {"hits_at_k_s": [1, 3]},
        "console": {"quiet": True},
        "random_seed": {"default": 3},
    }
    for key, value in CROSSING[case].items():
        conf[key] = {**conf.get(key, {}), **value} if isinstance(value, dict) else value
    (tmp_path / "toy.yaml").write_text(yaml.safe_dump(conf))
    folder = tmp_path / "exp"
    _run([sys.executable, "-m", "kge_tpu_torch", "start", str(tmp_path / "toy.yaml"),
          "--folder", str(folder)], cwd=tmp_path)
    saved = jax_load_checkpoint(str(folder / "checkpoint_00002.pt"))
    leaves = saved["optimizer_state"]["leaves"]
    assert len(leaves) == (3 if case == "rt3_kvsall" else 2)
    assert all(sorted(leaf) == ["sum"] for leaf in leaves)
    if case == "rt3_kvsall":
        tree = saved["model"][0]["relation_embedder"]
        assert sorted(tree) == ["base", "projection"]
        assert tree["projection"].shape == (64, 4)
    _run([sys.executable, "-m", "kge_tpu", "resume", str(folder),
          "--train.max_epochs", "3"], cwd=tmp_path)
    _run([sys.executable, "-m", "kge_tpu_torch", "resume", str(folder),
          "--job.device", "cpu", "--train.max_epochs", "4"], cwd=tmp_path)
    epochs = _entries(folder, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == [1, 2, 3, 4]
    assert all(math.isfinite(e["avg_loss"]) for e in epochs)
    assert epochs[3]["avg_loss"] < epochs[0]["avg_loss"]
    last = jax_load_checkpoint(str(folder / "checkpoint_00004.pt"))
    assert int(last["optimizer_state"]["step"]) == 4 * int(
        saved["optimizer_state"]["step"]) // 2
    # Adagrad's sum went on from the saved one across both packages
    for before, after in zip(leaves, last["optimizer_state"]["leaves"]):
        assert (np.asarray(after["sum"]) >= np.asarray(before["sum"])).all()
    _run([sys.executable, "-m", "kge_tpu", "test", str(folder)], cwd=tmp_path)
    _run([sys.executable, "-m", "kge_tpu_torch", "test", str(folder),
          "--job.device", "cpu"], cwd=tmp_path)
    want, got = (_metrics(e) for e in _entries(
        folder, event="eval_completed", split="test"))
    assert 0.0 < want["mean_reciprocal_rank_filtered"] <= 1.0
    assert got == want
