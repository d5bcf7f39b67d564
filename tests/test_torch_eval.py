"""Filtered entity-ranking evaluation of kge_tpu_torch against kge_tpu: the
same weights (made by kge_tpu, carried across through numpy) evaluated by
both packages on the CPU must give the same trace entry, metric by metric
and exactly — the rank histograms are integer, so the floats are identical.

Covers plain and reciprocal ComplEx (the rank kernel's route), the distance
models (TransE and RotatE under L1 by the score matrix and under L2 by the
rank kernel with its sqrt epilogue, TransH by the score matrix), the three
tie policies, ranking with a chunk_size below |E| and kge_tpu's flat label
layout on its side, filter_with_test, the head/tail, relation-type and
argument-frequency drill-downs and the consistency warning, on
tests/data/dataset_test and on a seeded synthetic graph."""

import math

import numpy as np
import pytest
import torch

from kge_tpu.job import EvaluationJob as JaxEvaluationJob
from kge_tpu.job.eval_entity_ranking import EntityRankingJob as JaxRankingJob
from kge_tpu_torch.job import EvaluationJob
from tests.torch_parity import make_pair, model_options
from tests.util import DATASET_DIR, make_synthetic_dataset

DRILL_DOWNS = {
    "entity_ranking.filter_with_test": True,
    "entity_ranking.metrics_per.head_and_tail": True,
    "entity_ranking.metrics_per.relation_type": True,
    "entity_ranking.metrics_per.argument_frequency": True,
}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """About 300 entities, 6 relations and 3k triples; 150 valid triples so
    that the last eval batch of 64 is padded."""
    return make_synthetic_dataset(
        tmp_path_factory.mktemp("torch_eval") / "eval_synth",
        num_entities=300, num_relations=6, num_train=3000, num_valid=150,
        num_test=150, seed=21,
    )


#: the distance models: name -> options
DISTANCE_MODELS = {
    "transe": {"model": "transe"},
    "transe_l2": {"model": "transe", "transe.l_norm": 2.0},
    "rotate": {"model": "rotate"},
    "rotate_l2": {"model": "rotate", "rotate.l_norm": 2.0},
    "transh": {"model": "transh"},
}


def _warnings_of(config):
    """The WARNING lines that ``config`` logs from now on."""
    seen = []
    log = config.log

    def record(msg, *args, **kwargs):
        if "WARNING" in str(msg):
            seen.append(str(msg))
        return log(msg, *args, **kwargs)

    config.log = record
    return seen


def _evaluate_both(folder, dataset_name, model, options, perrow_budget=None,
                   warnings=None):
    options = {**model_options(model), **options}
    jmodel, params, tmodel = make_pair(folder, dataset_name, options, seed=5)
    if warnings is not None:
        warnings["kge_tpu"] = _warnings_of(jmodel.config)
        warnings["port"] = _warnings_of(tmodel.config)

    jjob = JaxEvaluationJob.create(jmodel.config, jmodel.dataset, model=jmodel)
    jjob.model_params = params
    jjob.epoch = 0
    old = JaxRankingJob._PERROW_BUDGET
    if perrow_budget is not None:
        JaxRankingJob._PERROW_BUDGET = perrow_budget
    try:
        expected = jjob._evaluate()
    finally:
        JaxRankingJob._PERROW_BUDGET = old

    tjob = EvaluationJob.create(tmodel.config, tmodel.dataset, model=tmodel)
    tjob.epoch = 0
    with torch.inference_mode():
        got = tjob._evaluate()
    return expected, got


def _assert_same_entry(expected, got):
    assert set(got) == set(expected)
    metric_keys = [
        k for k in expected
        if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
    ]
    assert len(metric_keys) > 20
    for key, value in expected.items():
        if key == "epoch_time":
            continue
        if isinstance(value, float) and math.isnan(value):
            assert math.isnan(got[key]), key
        else:
            assert got[key] == value, (key, value, got[key])


@pytest.mark.parametrize("model", ["complex", "reciprocal_complex"])
@pytest.mark.parametrize("ties", ["rounded_mean_rank", "best_rank", "worst_rank"])
@pytest.mark.parametrize("chunk_size", [-1, 70])
def test_synthetic_eval_matches_kge_tpu(synth, model, ties, chunk_size):
    options = {
        **DRILL_DOWNS,
        "eval.split": "valid",
        "eval.batch_size": 64,
        "entity_ranking.chunk_size": chunk_size,
        "entity_ranking.tie_handling.type": ties,
        # wide enough that the tie policies change ranks
        "entity_ranking.tie_handling.atol": "0.02",
    }
    expected, got = _evaluate_both(synth, "eval_synth", model, options)
    _assert_same_entry(expected, got)
    if ties != "best_rank":
        best = _evaluate_both(
            synth, "eval_synth", model,
            {**options, "entity_ranking.tie_handling.type": "best_rank"},
        )[1]
        assert best["mean_rank_filtered"] != got["mean_rank_filtered"]


@pytest.mark.parametrize("model", ["complex", "reciprocal_complex"])
def test_flat_label_layout_of_kge_tpu(synth, model):
    """kge_tpu switches to its flat (rows, cols) label layout under row
    skew; the port's CSR labels equal it as well."""
    options = {**DRILL_DOWNS, "eval.split": "valid", "eval.batch_size": 32}
    expected, got = _evaluate_both(synth, "eval_synth", model, options,
                                   perrow_budget=0)
    _assert_same_entry(expected, got)


@pytest.mark.parametrize("model", ["complex", "reciprocal_complex"])
@pytest.mark.parametrize("split", ["valid", "test"])
def test_dataset_test_eval_matches_kge_tpu(model, split):
    options = {**DRILL_DOWNS, "eval.split": split, "eval.batch_size": 2}
    expected, got = _evaluate_both(DATASET_DIR, "dataset_test", model, options)
    _assert_same_entry(expected, got)


@pytest.mark.parametrize("split", ["valid", "test"])
@pytest.mark.parametrize("chunk_size", [-1, 70])
@pytest.mark.parametrize("name", list(DISTANCE_MODELS))
def test_distance_model_eval_matches_kge_tpu(synth, name, chunk_size, split):
    """Every metric of kge_tpu's trace entry, exactly, by both routes of the
    port: the rank kernel (L2) and the score matrix, over all of |E| at once
    and in chunks of 70 columns; neither package warns."""
    options = {
        **DISTANCE_MODELS[name],
        **DRILL_DOWNS,
        "eval.split": split,
        "eval.batch_size": 64,
        "entity_ranking.chunk_size": chunk_size,
    }
    warnings = {}
    expected, got = _evaluate_both(synth, "eval_synth", options["model"], options,
                                   warnings=warnings)
    _assert_same_entry(expected, got)
    assert warnings == {"kge_tpu": [], "port": []}


@pytest.mark.parametrize("name", ["transe", "transe_l2", "transh"])
def test_distance_model_eval_tie_policy_matches_kge_tpu(synth, name):
    """With a wide tie tolerance the worst-rank policy moves ranks, in both
    packages alike."""
    options = {
        **DISTANCE_MODELS[name],
        "eval.split": "valid",
        "eval.batch_size": 64,
        "entity_ranking.tie_handling.type": "worst_rank",
        "entity_ranking.tie_handling.atol": "0.5",
    }
    expected, got = _evaluate_both(synth, "eval_synth", options["model"], options)
    _assert_same_entry(expected, got)
    best = _evaluate_both(synth, "eval_synth", options["model"], {
        **options, "entity_ranking.tie_handling.type": "best_rank"})[1]
    assert best["mean_rank_filtered"] != got["mean_rank_filtered"]


@pytest.mark.parametrize("name,warns", [("transe_l2", True), ("rotate_l2", True),
                                         ("transe", False), ("transh", False)])
def test_consistency_warning_where_kge_tpu_warns(synth, name, warns):
    """At zero tie tolerance the L2 factorization's cancellation puts the
    pivot off the spo score: both packages warn (and report the same
    metrics); the score matrix's pivot equals its true score and neither
    package warns."""
    options = {
        **DISTANCE_MODELS[name],
        "eval.split": "valid",
        "eval.batch_size": 64,
        "entity_ranking.tie_handling.atol": "0.0",
        "entity_ranking.tie_handling.rtol": "0.0",
    }
    warnings = {}
    expected, got = _evaluate_both(synth, "eval_synth", options["model"], options,
                                   warnings=warnings)
    _assert_same_entry(expected, got)
    assert bool(warnings["kge_tpu"]) == bool(warnings["port"]) == warns


def test_collate_cache_reused_across_epochs(synth):
    """A second evaluation reuses the collated batches and reports the same
    metrics."""
    _, _, tmodel = make_pair(
        synth, "eval_synth", {**model_options("complex"), "eval.split": "valid"}
    )
    job = EvaluationJob.create(tmodel.config, tmodel.dataset, model=tmodel)
    with torch.inference_mode():
        first = job._evaluate()
        cache = job._collate_cache
        second = job._evaluate()
    assert job._collate_cache is cache
    for key in first:
        if key.startswith("mean_reciprocal_rank"):
            assert np.array_equal(first[key], second[key], equal_nan=True)
