"""The training-loss evaluation (``eval.type: training_loss``) of
kge_tpu_torch against kge_tpu on the CPU: a forward-only training job over
``eval.split`` whose ``avg_loss``, ``avg_penalty`` and ``avg_cost`` equal
kge_tpu's (rtol 1e-5), from the same weights, standalone and as the
validation of a training job. kge_tpu computes the loss in train mode, so
ConvE's batch norm normalizes by the batch statistics; the evaluation
changes no parameter, statistic or optimizer state and leaves the model's
mode as it found it. Cases: reciprocal ConvE with 1vsAll, the same in
subbatches, reciprocal ConvE and the Transformer with negative sampling
(host-drawn negatives, which both packages draw alike), on a seeded
synthetic graph with a padded last batch; the entity-pair placeholder; and
``start`` of examples/toy-conve-train.yaml validating by training loss."""

import math
import sys

import jax
import numpy as np
import pytest

import kge_tpu
import kge_tpu_torch
from kge_tpu.job import EvaluationJob as JaxEvaluationJob
from kge_tpu_torch.job import EvaluationJob, TrainingLossEvaluationJob
from kge_tpu_torch.models import load_jax_params, to_jax_params
from tests.test_torch_cli import EXAMPLES_DIR, _entries, _run, _toy_cwd
from tests.torch_parity import (
    make_config,
    make_job_pair,
    make_pair,
    neural_options,
    random_stats,
)
from tests.util import DATASET_DIR, make_synthetic_dataset

SYNTH = "training_loss_synth"
NEGSAMP = {"train.type": "negative_sampling", "train.loss": "kl",
           "negative_sampling.on_device": "never",
           "negative_sampling.num_samples.s": 3,
           "negative_sampling.num_samples.o": 4}
CASES = {
    "conve-1vsAll": ("conve", {"train.type": "1vsAll", "train.loss": "kl",
                               "lookup_embedder.regularize": "lp",
                               "lookup_embedder.regularize_weight": 1e-3}),
    "conve-1vsAll-subbatch": ("conve", {"train.type": "1vsAll",
                                        "train.loss": "kl",
                                        "train.subbatch_size": 4}),
    "conve-negsamp": ("conve", NEGSAMP),
    "transformer-negsamp": ("transformer", {**NEGSAMP, "train.loss": "bce"}),
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """64 entities, 8 relations; 20 validation triples, so that batches of 8
    end in a padded one."""
    return make_synthetic_dataset(
        tmp_path_factory.mktemp("torch_training_loss") / SYNTH,
        num_entities=64, num_relations=8, num_train=200, num_valid=20,
        num_test=20, seed=9,
    )


def _options(case, **extra):
    model, options = CASES[case]
    return neural_options(model, **{
        **options, "train.batch_size": 8, "eval.type": "training_loss",
        "eval.split": "valid", "valid.every": 0, **extra})


def _snapshot(model):
    return jax.tree_util.tree_leaves(to_jax_params(model))


def _same_losses(got, want):
    for key in ("avg_loss", "avg_penalty", "avg_cost"):
        assert math.isfinite(got[key]), key
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, atol=1e-7,
                                   err_msg=key)
    for key in ("type", "scope", "split", "epoch", "event"):
        assert got[key] == want[key], key


@pytest.mark.parametrize("mode", ["train", "eval"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_standalone_matches_kge_tpu(synth, case, mode):
    jmodel, params, tmodel = make_pair(synth, SYNTH, _options(case), seed=2)
    params = random_stats(params)
    load_jax_params(tmodel, params)
    jjob = JaxEvaluationJob.create(jmodel.config, jmodel.dataset, model=jmodel)
    jjob.model_params = params
    jjob.epoch = 1
    tjob = EvaluationJob.create(tmodel.config, tmodel.dataset, model=tmodel)
    assert isinstance(tjob, TrainingLossEvaluationJob)
    tjob.epoch = 1
    before = _snapshot(tmodel)
    tmodel.train(mode == "train")
    for _ in range(2):  # the second run reuses the prepared forward-only job
        want, got = jjob.run(), tjob.run()
        _same_losses(got, want)
        assert tmodel.training == (mode == "train")
        for a, b in zip(_snapshot(tmodel), before, strict=True):
            np.testing.assert_array_equal(a, b)
    assert want["type"] == "training_loss" and want["split"] == "valid"
    forward = tjob._train_job
    assert forward.is_forward_only and forward.opt_state is None
    assert forward.optimizer is None
    assert all(p.grad is None for p in tmodel.parameters())


@pytest.mark.parametrize("case", ["conve-1vsAll", "conve-negsamp"])
def test_validation_during_training_matches_kge_tpu(synth, case):
    """``valid.every`` with ``eval.type: training_loss``: after an epoch of
    training (kge_tpu unscanned), each package's validation job reports the
    loss of the validation split; the statistics the epoch left are those
    the evaluation reads and leaves."""
    options = _options(case, **{
        "valid.every": 1, "train.epoch_scan": "never",
        "train.optimizer.default.type": "Adagrad",
        "train.optimizer.default.args.lr": 0.1,
        "train.optimizer.default.args.initial_accumulator_value": 0.1,
    })
    jjob, tjob = make_job_pair(synth, SYNTH, options)
    jjob.epoch = tjob.epoch = 1
    np.testing.assert_allclose(tjob.run_epoch()["avg_loss"],
                               jjob.run_epoch()["avg_loss"], rtol=1e-4)
    after_epoch = _snapshot(tjob.model)
    jjob.valid_job.epoch = tjob.valid_job.epoch = 1
    jjob.valid_job.model_params = jjob.model_params
    want, got = jjob.valid_job.run(), tjob.valid_job.run()
    for key in ("avg_loss", "avg_penalty", "avg_cost"):
        np.testing.assert_allclose(got[key], want[key], rtol=1e-5, err_msg=key)
    assert got["type"] == want["type"] == "training_loss"
    for a, b in zip(_snapshot(tjob.model), after_epoch, strict=True):
        np.testing.assert_array_equal(a, b)
    assert tjob.model.training
    # training goes on from the state the evaluation left
    tjob.epoch = 2
    assert math.isfinite(tjob.run_epoch()["avg_loss"])


def test_entity_pair_ranking_is_kge_tpus_placeholder():
    """Both packages create the job and neither evaluates with it."""
    for package, create in ((kge_tpu, JaxEvaluationJob.create),
                            (kge_tpu_torch, EvaluationJob.create)):
        config = make_config(package, "dataset_test", {
            "model": "complex", "eval.type": "entity_pair_ranking"})
        dataset = package.Dataset.create(config, folder=str(DATASET_DIR))
        kwargs = {"device": "cpu"} if package is kge_tpu_torch else {}
        model = package.models.KgeModel.create(config, dataset, **kwargs)
        job = create(config, dataset, model=model)
        assert type(job).__name__ == "EntityPairRankingJob"
        with pytest.raises(NotImplementedError):
            job._evaluate()


def test_toy_conve_validates_by_training_loss(tmp_path):
    """``start`` of the toy ConvE example with ``eval.type training_loss``:
    the validations report finite losses under the trace keys of kge_tpu,
    and ``valid`` evaluates the folder the same way (the example's dropout
    is on in train mode, so the values differ from run to run)."""
    cwd = _toy_cwd(tmp_path)
    folder = cwd / "conve"
    _run([sys.executable, "-m", "kge_tpu_torch", "start",
          str(EXAMPLES_DIR / "toy-conve-train.yaml"), "--job.device", "cpu",
          "--train.max_epochs", "4", "--valid.every", "2",
          "--eval.type", "training_loss", "--valid.metric", "avg_loss",
          "--valid.metric_max", "false", "--folder", str(folder)], cwd=cwd)
    valid = _entries(folder, event="eval_completed")
    assert [e["epoch"] for e in valid] == [2, 4]
    for entry in valid:
        assert entry["type"] == "training_loss" and entry["split"] == "valid"
        assert math.isfinite(entry["avg_loss"]) and entry["avg_loss"] > 0
        assert entry["avg_cost"] == pytest.approx(
            entry["avg_loss"] + entry["avg_penalty"])
    assert (folder / "checkpoint_best.pt").exists()
    _run([sys.executable, "-m", "kge_tpu_torch", "valid", str(folder),
          "--job.device", "cpu", "--eval.type", "training_loss"], cwd=cwd)
    again = _entries(folder, event="eval_completed")[-1]
    assert again["type"] == "training_loss" and again["job"] == "eval"
    assert math.isfinite(again["avg_loss"]) and again["avg_loss"] > 0
