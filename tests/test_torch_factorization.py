"""DistMult, RESCAL, CP, SimplE and RelationalTucker3 of kge_tpu_torch
against kge_tpu on the CPU, with kge_tpu's weights carried across
(models/convert.py, nested parameter trees included): every scoring
function and the rank kernel's queries within rtol 1e-5, atol 1e-6 (the
same float32 products, summed in other orders); filtered evaluation
metrics exactly equal (integer rank histograms, the rank kernel's plain
version); penalties; five KvsAll steps of each model; projection dropout in
train mode only; the models' configuration rules."""

import numpy as np
import pytest
import torch

import kge_tpu
import kge_tpu_torch
from kge_tpu.ops import pallas_ops
from kge_tpu_torch.models import (
    CP,
    DistMult,
    ProjectionEmbedder,
    RelationalTucker3,
    Rescal,
    SimplE,
    Tucker3RelationEmbedder,
    param_leaves,
    to_jax_params,
)
from kge_tpu_torch.ops import embedding_ops
from kge_tpu_torch.ops.optim import parameter_name
from tests.test_torch_eval import DRILL_DOWNS, _assert_same_entry, _evaluate_both
from tests.torch_parity import (
    assert_same_state,
    make_config,
    make_job_pair,
    make_pair,
    run_batch_steps,
    torch_tables,
)
from tests.util import make_synthetic_dataset

TOL = dict(rtol=1e-5, atol=1e-6)
SYNTH = "factorization_synth"

#: weights at the scale of a trained model's: normal, std 0.1 (the Tucker3
#: projection 0.3), so that float32 rounding stays far below the tolerances
#: (at std 1, RESCAL's 256-term sums round to 1e-5 absolute)
INIT = {"lookup_embedder.initialize_args.std": 0.1}

#: model name -> (class, options at the toy widths of examples/toy-rt3-train.yaml)
MODELS = {
    "distmult": (DistMult, {"model": "distmult", "lookup_embedder.dim": 16, **INIT}),
    "rescal": (Rescal, {"model": "rescal", "lookup_embedder.dim": 16, **INIT}),
    "cp": (CP, {"model": "cp", "lookup_embedder.dim": 16, **INIT}),
    "simple": (SimplE, {"model": "simple", "lookup_embedder.dim": 16, **INIT}),
    "relational_tucker3": (RelationalTucker3, {
        "model": "relational_tucker3",
        "relational_tucker3.entity_embedder.dim": 16,
        "relational_tucker3.relation_embedder.base_embedder.dim": 8,
        "relational_tucker3.relation_embedder.initialize_args.std": 0.3,
        **INIT,
    }),
}


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    pallas_ops.set_gather_mode("xla")
    embedding_ops.set_gather_mode("torch")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(
        tmp_path_factory.mktemp("torch_factorization") / SYNTH,
        num_entities=60, num_relations=5, num_train=400, num_valid=40,
        num_test=40, seed=11,
    )


def _triples(n, E, R, seed):
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.integers(0, E, n), rng.integers(0, R, n), rng.integers(0, E, n)],
        axis=1,
    ).astype(np.int32)


def _close(got, want):
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_scores_match_kge_tpu(synth, model):
    cls, options = MODELS[model]
    jmodel, params, tmodel = make_pair(synth, SYNTH, options)
    assert type(tmodel) is cls
    t = _triples(17, 60, 5, seed=1)
    s, p, o = (t[:, i] for i in range(3))
    ts, tp, to = (torch.from_numpy(x) for x in (s, p, o))
    with torch.no_grad():
        _close(tmodel.score_spo(ts, tp, to), jmodel.score_spo(params, s, p, o))
        _close(tmodel.score_sp(ts, tp), jmodel.score_sp(params, s, p))
        _close(tmodel.score_po(tp, to), jmodel.score_po(params, p, o))
        _close(tmodel.score_so(ts, to), jmodel.score_so(params, s, o))
        ents = np.arange(5, 40, dtype=np.int32)
        rels = np.array([4, 0, 2], dtype=np.int32)
        _close(tmodel.score_sp(ts, tp, torch.from_numpy(ents)),
               jmodel.score_sp(params, s, p, ents))
        _close(tmodel.score_po(tp, to, torch.from_numpy(ents)),
               jmodel.score_po(params, p, o, ents))
        _close(tmodel.score_so(ts, to, torch.from_numpy(rels)),
               jmodel.score_so(params, s, o, rels))
        _close(tmodel.score_sp_po(ts, tp, to, torch.from_numpy(ents)),
               jmodel.score_sp_po(params, s, p, o, ents))
        rng = np.random.default_rng(2)
        for slot, vocab in ((0, 60), (1, 5), (2, 60)):
            samples = rng.integers(0, vocab, (17, 6)).astype(np.int32)
            _close(tmodel.score_spo_neg(torch.from_numpy(t), torch.from_numpy(samples),
                                        slot),
                   jmodel.score_spo_neg(params, t, samples, slot))


@pytest.mark.parametrize("model", sorted(MODELS))
def test_factorized_queries_match_kge_tpu(synth, model):
    """pos and query . targets of every slot equal kge_tpu's grouped scores
    against the whole vocabulary; the rank kernel consumes exactly these."""
    jmodel, params, tmodel = make_pair(synth, SYNTH, MODELS[model][1])
    t = _triples(9, 60, 5, seed=3)
    targets = {0: np.arange(60, dtype=np.int32), 1: np.arange(5, dtype=np.int32),
               2: np.arange(60, dtype=np.int32)}
    want = jmodel.score_all_grouped_multi(params, t, (0, 1, 2), targets=targets)
    with torch.no_grad():
        got = tmodel.factorized_queries(torch.from_numpy(t).long(), (0, 1, 2))
    for slot in (0, 1, 2):
        pos, q, table, score_map = got[slot]
        assert score_map is None
        _close(pos, want[slot][0])
        _close(q @ table.T, want[slot][1])


@pytest.mark.parametrize("model", sorted(MODELS))
def test_eval_matches_kge_tpu(synth, model):
    """Filtered ranking through the rank kernel's plain version: every
    metric of kge_tpu's trace entry, exactly."""
    options = {
        **MODELS[model][1], **DRILL_DOWNS,
        "eval.split": "valid", "eval.batch_size": 16,
    }
    expected, got = _evaluate_both(synth, SYNTH, model, options)
    _assert_same_entry(expected, got)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_penalties_match_kge_tpu(synth, model):
    """lp penalties of the lookup tables and of the projection (weighted by
    the batch's indexes for the relation embedder's base), as kge_tpu
    computes them. No mask: kge_tpu's weighted relation penalty raises on
    one (ROADMAP.md C.2)."""
    options = {
        **MODELS[model][1],
        "lookup_embedder.regularize_weight": 0.01,
        "lookup_embedder.regularize_args.p": 3,
    }
    if model == "relational_tucker3":
        options.update({
            "relational_tucker3.relation_embedder.regularize_weight": 0.02,
            "relational_tucker3.relation_embedder.base_embedder.regularize_weight": 0.03,
            "relational_tucker3.relation_embedder.base_embedder.regularize_args.weighted":
                True,
        })
    jmodel, params, tmodel = make_pair(synth, SYNTH, options)
    t = _triples(12, 60, 5, seed=4)
    want = jmodel.penalty(params, batch={"triples": t})
    with torch.no_grad():
        got = tmodel.penalty(batch={"triples": torch.from_numpy(t).long()})
    assert [name for name, _ in got] == [name for name, _ in want]
    assert len(got) == (3 if model == "relational_tucker3" else 2)
    for (_, g), (_, w) in zip(got, want):
        _close(g, w)


@pytest.mark.parametrize("model", sorted(MODELS))
def test_kvsall_trajectory_matches_kge_tpu(synth, model):
    """Five KvsAll steps (sp_ and _po) of each model from the same weights:
    RESCAL's and the Tucker3 core's relation gradients are [R, d^2], the
    Tucker3 projection's [d^2, d_r]; RelationalTucker3's optimizer state
    has three leaves, in kge_tpu's order. The projection takes its own
    optimizer group by regex (kge_tpu's parameter names)."""
    options = {
        **MODELS[model][1],
        "train.type": "KvsAll",
        "train.batch_size": 32,
        "train.loss": "kl",
        "train.optimizer.default.type": "Adagrad",
        "train.optimizer.default.args.lr": 0.1,
        "train.optimizer.default.args.initial_accumulator_value": 0.1,
        "valid.every": 0,
    }
    if model == "relational_tucker3":
        options.update({
            "train.optimizer.projection.regex": ".*_projection.*",
            "train.optimizer.projection.type": "Adagrad",
            "train.optimizer.projection.args.lr": 0.02,
            "train.optimizer.projection.args.initial_accumulator_value": 0.1,
        })
    jjob, tjob = make_job_pair(synth, SYNTH, options)
    start = [t.copy() for t in torch_tables(tjob)]
    for want, got in run_batch_steps(jjob, tjob):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_same_state(jjob, tjob)
    # every table moved by more than four times the tables' tolerance
    moved = [np.abs(a - b).max() for a, b in zip(torch_tables(tjob), start)]
    assert min(moved) > 2e-5
    if model == "relational_tucker3":
        assert [path for path, _ in param_leaves(tjob.model)] == [
            ("entity_embedder", "embeddings"),
            ("relation_embedder", "base", "embeddings"),
            ("relation_embedder", "projection"),
        ]
        assert tjob.optimizer.base_lrs().tolist() == pytest.approx([0.02, 0.1])


def test_nested_parameter_tree_round_trips(synth):
    """RelationalTucker3's relation embedder is kge_tpu's {"base":
    {"embeddings"}, "projection"} tree both ways, with its parameter names;
    a tree of another shape is refused."""
    from kge_tpu_torch.models import load_jax_params

    _, params, tmodel = make_pair(synth, SYNTH, MODELS["relational_tucker3"][1])
    rel = tmodel.get_p_embedder()
    assert type(rel) is Tucker3RelationEmbedder and isinstance(rel, ProjectionEmbedder)
    assert rel.dim == 256 and rel.base_embedder.dim == 8
    back = to_jax_params(tmodel)
    assert sorted(back["relation_embedder"]) == ["base", "projection"]
    np.testing.assert_array_equal(back["relation_embedder"]["projection"],
                                  params["relation_embedder"]["projection"])
    np.testing.assert_array_equal(back["relation_embedder"]["base"]["embeddings"],
                                  params["relation_embedder"]["base"]["embeddings"])
    assert [parameter_name(path) for path, _ in param_leaves(tmodel)] == [
        "_entity_embedder._embeddings.weight",
        "_relation_embedder._base_embedder._embeddings.weight",
        "_relation_embedder._projection.weight",
    ]
    flat = {"entity_embedder": params["entity_embedder"],
            "relation_embedder": {"embeddings": params["relation_embedder"]["projection"]}}
    with pytest.raises(ValueError, match="do not match"):
        load_jax_params(tmodel, flat)


def test_projection_dropout_acts_in_train_mode_only(synth):
    options = {**MODELS["relational_tucker3"][1],
               "relational_tucker3.relation_embedder.dropout": 0.5}
    _, _, tmodel = make_pair(synth, SYNTH, options)
    rel = tmodel.get_p_embedder()
    rel.dropout_generator = torch.Generator().manual_seed(0)
    ids = torch.arange(5)
    with torch.no_grad():
        tmodel.eval()
        plain = rel.base_embedder.embed(ids) @ rel.projection.T
        assert torch.equal(rel.embed(ids), plain)
        assert torch.equal(rel.embed_all(), plain)
        tmodel.train()
        dropped = rel.embed(ids)
    zero = dropped == 0
    assert 0.3 < float(zero.float().mean()) < 0.7
    torch.testing.assert_close(dropped[~zero], 2.0 * plain[~zero])


@pytest.mark.parametrize("model,key,value", [
    ("rescal", "relation_embedder.dim", 256),
    ("relational_tucker3", "relation_embedder.dim", 256),
    ("cp", "relation_embedder.dim", 8),
    ("simple", "relation_embedder.dim", 16),
])
def test_relation_widths_set_as_in_kge_tpu(synth, model, key, value):
    jmodel, _, tmodel = make_pair(synth, SYNTH, MODELS[model][1])
    assert tmodel.config.get_default(f"{model}.{key}") == jmodel.config.get_default(
        f"{model}.{key}") == value
    assert tmodel.get_p_embedder().dim == value


@pytest.mark.parametrize("model", ["cp", "simple"])
def test_odd_width_refused_as_in_kge_tpu(synth, model):
    errors = []
    for package in (kge_tpu, kge_tpu_torch):
        config = make_config(package, SYNTH, {"model": model,
                                              "lookup_embedder.dim": 15})
        dataset = package.Dataset.create(config, folder=str(synth))
        with pytest.raises(ValueError) as info:
            package.models.KgeModel.create(config, dataset)
        errors.append(str(info.value))
    assert errors[0] == errors[1] and "even dimensionality" in errors[0]
