"""TransE and RotatE (L1, L2) and TransH of kge_tpu_torch against kge_tpu
on the CPU: scores from weights carried across (models/convert.py), the L2
factorization with its named sqrt epilogue, TransH's soft constraints,
five-step training trajectories with injected pools (random streams of jax
and torch cannot be compared), and where
``negative_sampling.implementation: auto`` resolves.

Tolerances. Scores: rtol 1e-5, atol 1e-5 (the same float32 differences,
summed over d in another order). Trajectories: losses rtol 1e-5; tables and
optimizer state as stated at each case. A TransE-L1 gradient is a sum of
signs weighted by multiples of 1 / batch size, so its Adagrad trajectory is
tight; RotatE's tables move by about lr = 0.001 a step under Adam, whose
update ``m_hat / (sqrt(v_hat) + eps)`` turns the rounding of a gradient
element into a change of the same relative size in a step of size lr, so its
tables are held to 2e-6, a five-hundredth of a step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kge_tpu
import kge_tpu_torch
from kge_tpu.ops import pallas_ops
from kge_tpu_torch.models import RotatE, TransE, TransH
from kge_tpu_torch.ops import embedding_ops
from tests.torch_parity import (
    jax_tables as _jax_tables,
    make_config,
    make_job_pair,
    make_pair,
    pooled_options,
    run_steps as _run_steps,
    torch_tables as _tables,
)
from tests.util import DATASET_DIR, make_synthetic_dataset

TOL = dict(rtol=1e-5, atol=1e-5)
E, R = 60, 5


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    pallas_ops.set_gather_mode("xla")
    embedding_ops.set_gather_mode("torch")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(
        tmp_path_factory.mktemp("torch_translation") / "translation_synth",
        num_entities=E, num_relations=R, num_train=400, num_valid=20,
        num_test=20, seed=3,
    )


def _triples(n, seed):
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.integers(0, E, n), rng.integers(0, R, n), rng.integers(0, E, n)],
        axis=1,
    ).astype(np.int32)


def _pair(synth, model, **extra):
    options = {"model": model, "lookup_embedder.dim": 20}
    options.update(extra)
    if model in VARIANTS:
        model, variant = VARIANTS[model]
        options.update(model=model, **variant)
    return make_pair(synth, "translation_synth", options)


#: the scorers under test beyond each model's default L1: name -> (model,
#: options)
VARIANTS = {
    "transe_l2": ("transe", {"transe.l_norm": 2.0}),
    "rotate_l2": ("rotate", {"rotate.l_norm": 2.0}),
    "transh_l2": ("transh", {"transh.l_norm": 2.0}),
}
MODELS = ["transe", "rotate", "transe_l2", "rotate_l2", "transh", "transh_l2"]
CLASSES = {"transe": TransE, "rotate": RotatE, "transh": TransH}


# -- scores ---------------------------------------------------------------------


@pytest.mark.parametrize("model", MODELS)
def test_scores_match_kge_tpu(synth, model):
    jmodel, params, tmodel = _pair(synth, model)
    assert type(tmodel) is CLASSES[model.split("_")[0]]
    if model.startswith("rotate"):
        # relation_embedder.dim: -1 resolves to half the entity dimension
        assert tmodel.get_p_embedder().embeddings.shape == (R, 10)
    if model.startswith("transh"):
        # [translation | normal]: twice the entity dimension
        assert tmodel.get_p_embedder().embeddings.shape == (R, 40)
    t = _triples(17, seed=1)
    s, p, o = (t[:, i] for i in range(3))
    ts, tp, to = (torch.from_numpy(x).long() for x in (s, p, o))
    with torch.no_grad():
        np.testing.assert_allclose(
            tmodel.score_spo(ts, tp, to).numpy(),
            np.asarray(jmodel.score_spo(params, s, p, o)), **TOL)
        np.testing.assert_allclose(
            tmodel.score_sp(ts, tp).numpy(),
            np.asarray(jmodel.score_sp(params, s, p)), **TOL)
        np.testing.assert_allclose(
            tmodel.score_po(tp, to).numpy(),
            np.asarray(jmodel.score_po(params, p, o)), **TOL)
        subset = np.arange(5, 40, dtype=np.int32)
        np.testing.assert_allclose(
            tmodel.score_sp(ts, tp, torch.from_numpy(subset).long()).numpy(),
            np.asarray(jmodel.score_sp(params, s, p, subset)), **TOL)
        np.testing.assert_allclose(
            tmodel.score_so(ts, to).numpy(),
            np.asarray(jmodel.score_so(params, s, o)), **TOL)
        # the spo score is the diagonal of the many-targets forms
        np.testing.assert_allclose(
            tmodel.score_sp(ts, tp, to).numpy().diagonal(),
            tmodel.score_spo(ts, tp, to).numpy(), **TOL)
        np.testing.assert_allclose(
            tmodel.score_po(tp, to, ts).numpy().diagonal(),
            tmodel.score_spo(ts, tp, to).numpy(), **TOL)


@pytest.mark.parametrize("slot", [0, 1, 2])
@pytest.mark.parametrize("model", MODELS)
def test_per_row_negative_scores_match_kge_tpu(synth, model, slot):
    jmodel, params, tmodel = _pair(synth, model)
    t = _triples(11, seed=2)
    samples = np.random.default_rng(slot).integers(
        0, R if slot == 1 else E, (11, 6)).astype(np.int32)
    want = np.asarray(jmodel.score_spo_neg(params, t, samples, slot))
    with torch.no_grad():
        got = tmodel.score_spo_neg(
            torch.from_numpy(t).long(), torch.from_numpy(samples).long(), slot)
    assert got.shape == (11, 6)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    # each column is the spo score of the corrupted triple
    corrupted = torch.from_numpy(t).long().clone()
    corrupted[:, slot] = torch.from_numpy(samples[:, 3]).long()
    with torch.no_grad():
        np.testing.assert_allclose(
            got[:, 3].numpy(),
            tmodel.score_spo(*(corrupted[:, i] for i in range(3))).numpy(), **TOL)


@pytest.mark.parametrize("route", ["never", "always"])
@pytest.mark.parametrize("slot", [0, 1, 2])
@pytest.mark.parametrize("model", ["transe", "rotate", "transe_l2", "transh"])
def test_pooled_negative_scores_match_kge_tpu(synth, model, slot, route):
    """Both routes of score_spo_neg_pooled (``always``: pooled_dist_scores,
    which kge_tpu runs as its interpreted kernel; ``never``: the one-hot
    select) against kge_tpu's same route, values and table gradients."""
    jmodel, params, tmodel = _pair(
        synth, model, **{"negative_sampling.pooled_kernel": route})
    n, K, F = 9, 5, 3
    t = _triples(n, seed=4)
    rng = np.random.default_rng(10 + slot)
    pool = rng.integers(0, R if slot == 1 else E, K * F).astype(np.int32)
    sel = rng.integers(0, F, (n, K)).astype(np.int32)
    w = rng.normal(size=(n, K)).astype(np.float32)

    def jloss(params):
        scores = jmodel.score_spo_neg_pooled(params, t, pool, sel, F, slot)
        return jnp.sum(scores * w), scores

    (_, want), jgrads = jax.value_and_grad(jloss, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    tt = torch.from_numpy(t).long()
    got = tmodel.score_spo_neg_pooled(
        tt, torch.from_numpy(pool).long(), torch.from_numpy(sel).long(), F, slot)
    assert got.shape == (n, K)
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), **TOL)
    # row i, column j scores candidate pool[j * F + sel[i, j]]
    cand = pool[np.arange(K)[None, :] * F + sel]
    with torch.no_grad():
        direct = tmodel.score_spo_neg(tt, torch.from_numpy(cand).long(), slot)
    np.testing.assert_allclose(got.detach().numpy(), direct.numpy(), **TOL)
    tables = [tmodel.get_s_embedder().embeddings, tmodel.get_p_embedder().embeddings]
    grads = torch.autograd.grad(torch.sum(got * torch.from_numpy(w)), tables)
    for g, key in zip(grads, ("entity_embedder", "relation_embedder")):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(jgrads[key]["embeddings"]), rtol=1e-5, atol=2e-5)


def test_kernel_forms():
    """TransE has a kernel form for every slot, RotatE for the entity slots
    only (a relation candidate multiplies into s), neither off the L1 norm."""
    from kge_tpu_torch.models.translation import RotatEScorer, TransEScorer

    config = make_config(kge_tpu_torch, "dataset_test",
                         {"model": "transe", "lookup_embedder.dim": 8})
    transe = TransEScorer(config, None, "transe")
    e = torch.randn(4, 8)
    for slot in (0, 1, 2):
        kind, (q,) = transe.pooled_kernel_queries(e, e, e, slot)
        assert kind == "l1" and q.shape == (4, 8)
    config = make_config(kge_tpu_torch, "dataset_test",
                         {"model": "rotate", "lookup_embedder.dim": 8})
    rotate = RotatEScorer(config, None, "rotate")
    ph = torch.randn(4, 4)
    assert rotate.pooled_kernel_queries(e, ph, e, 1) is None
    for slot in (0, 2):
        kind, (q_re, q_im) = rotate.pooled_kernel_queries(e, ph, e, slot)
        assert kind == "cmod" and q_re.shape == q_im.shape == (4, 4)
    rotate._norm = 3.0
    assert rotate.pooled_kernel_queries(e, ph, e, 2) is None


@pytest.mark.parametrize("model", ["transe", "rotate"])
def test_l2_norm_is_not_ported(model):
    """``l_norm: 2`` is a matrix-product scorer: no pairwise flag (so that
    ``auto`` keeps the standard ladder), no pooled kernel form, and the
    entity slots factorize with the named sqrt epilogue."""
    from kge_tpu_torch.ops.rank_kernel import NEG_SQRT_L2

    config = make_config(kge_tpu_torch, "dataset_test",
                         {"model": model, "lookup_embedder.dim": 8,
                          f"{model}.l_norm": 2.0})
    dataset = kge_tpu_torch.Dataset.create(config, folder=str(DATASET_DIR))
    scorer = kge_tpu_torch.models.KgeModel.create(config, dataset).get_scorer()
    assert scorer.pairwise_many_targets is False
    e, ph = torch.randn(4, 8), torch.randn(4, 4 if model == "rotate" else 8)
    for slot in (0, 2):
        assert scorer.pooled_kernel_queries(e, ph, e, slot) is None
        query, target_map, score_map = scorer.factorize_slot(e, ph, e, slot)
        # [2q | -1 | -||q||^2] padded with zeros to a multiple of 4
        assert query.shape == (4, 12) and score_map is NEG_SQRT_L2
        assert target_map(e).shape == (4, 12)
        assert torch.all(query[:, 10:] == 0)
    assert (scorer.factorize_slot(e, ph, e, 1) is None) == (model == "rotate")


@pytest.mark.parametrize("slot", [0, 1, 2])
@pytest.mark.parametrize("model", ["transe_l2", "rotate_l2"])
def test_l2_factorization_matches_kge_tpu(synth, model, slot):
    """factorize_slot against kge_tpu's: the augmented query and targets
    (the port's carry zero columns at the end), the epilogue, and the
    epilogued product against the many-targets forms."""
    jmodel, params, tmodel = _pair(synth, model)
    t = _triples(13, seed=6)
    ent = params["entity_embedder"]["embeddings"]
    rel = params["relation_embedder"]["embeddings"]
    embs = [ent[t[:, 0]], rel[t[:, 1]], ent[t[:, 2]]]
    kept = [None if i == slot else e for i, e in enumerate(embs)]
    want = jmodel.get_scorer().factorize_slot(params, *kept, slot, None)
    got = tmodel.get_scorer().factorize_slot(
        *(None if e is None else torch.tensor(e) for e in kept), slot)
    if model == "rotate_l2" and slot == 1:
        assert want is None and got is None
        return
    jq, jmap, jscore = want
    q, target_map, score_map = got
    width = jq.shape[1]
    assert q.shape[1] % 4 == 0 and q.shape[1] - width < 4
    np.testing.assert_allclose(q[:, :width].numpy(), np.asarray(jq), rtol=1e-5)
    assert torch.all(q[:, width:] == 0)
    table = rel if slot == 1 else ent
    jt = np.asarray(jmap(jnp.asarray(table)))
    targets = target_map(torch.tensor(table))
    np.testing.assert_allclose(targets[:, :width].numpy(), jt, rtol=1e-5)
    assert torch.all(targets[:, width:] == 0)
    # on the same products the epilogue is kge_tpu's to the last ulp (the
    # vectorized float32 sqrt of torch's and of XLA's CPU kernels may each
    # miss correct rounding, numpy's float32 sqrt, by one ulp)
    dot = np.asarray(jq) @ jt.T
    mapped = score_map(torch.from_numpy(dot)).numpy()
    for want in (np.asarray(jscore(jnp.asarray(dot))),
                 -np.sqrt(np.maximum(-dot, np.float32(0)) + np.float32(1e-30))):
        np.testing.assert_allclose(mapped, want, rtol=2.5e-7, atol=0)
    scores = score_map(q @ targets.T)
    np.testing.assert_allclose(scores.numpy(), np.asarray(jscore(jnp.asarray(dot))), **TOL)
    ts, tp, to = (torch.from_numpy(t[:, i]).long() for i in range(3))
    with torch.no_grad():
        direct = (tmodel.score_po(tp, to), tmodel.score_so(ts, to),
                  tmodel.score_sp(ts, tp))[slot]
    np.testing.assert_allclose(scores.numpy(), direct.numpy(), rtol=1e-4, atol=1e-4)


def test_transe_l2_score_so_shape_and_values():
    """s_o with a batch of 5 rows and 3 relations: the L2 expansion returns
    [n, R] row-aligned scores, equal to kge_tpu's and to the spo score of
    every (s, r, o) (a reshape keyed on the relation count would scramble
    them)."""
    jmodel, params, tmodel = make_pair(DATASET_DIR, "dataset_test", {
        "model": "transe", "lookup_embedder.dim": 16, "transe.l_norm": 2.0})
    R = tmodel.dataset.num_relations()
    assert R == 3
    s, o = np.array([0, 1, 2, 3, 4]), np.array([3, 4, 5, 6, 0])
    ts, to = torch.from_numpy(s), torch.from_numpy(o)
    with torch.no_grad():
        out = tmodel.score_so(ts, to)
        assert out.shape == (5, R)
        np.testing.assert_allclose(
            out.numpy(), np.asarray(jmodel.score_so(params, s, o)), **TOL)
        for p in range(R):
            np.testing.assert_allclose(
                out[:, p].numpy(),
                tmodel.score_spo(ts, torch.full((5,), p), to).numpy(),
                rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("weight", [0.0, 0.5])
def test_transh_penalty_matches_kge_tpu(synth, weight):
    """TransH's soft constraints (entity norms, orthogonality of translation
    and normal), weighted by C, beside the embedders' own penalties; values
    and table gradients."""
    jmodel, params, tmodel = _pair(synth, "transh", **{
        "transh.C": weight, "lookup_embedder.regularize_weight": 0.01})
    # some entity norms above 1, so that the first constraint is active
    params["entity_embedder"]["embeddings"] = (
        params["entity_embedder"]["embeddings"] * 3.0).astype(np.float32)
    kge_tpu_torch.models.load_jax_params(tmodel, params)
    t = _triples(8, seed=7)
    batch = {"triples": t, "mask": np.ones(8, np.float32)}

    def jtotal(params):
        terms = jmodel.penalty(params, batch={k: jnp.asarray(v) for k, v in batch.items()},
                               epoch=1)
        return sum(v for _, v in terms), terms

    (_, jterms), jgrads = jax.value_and_grad(jtotal, has_aux=True)(
        jax.tree_util.tree_map(jnp.asarray, params))
    terms = tmodel.penalty(batch={k: torch.from_numpy(v) for k, v in batch.items()},
                           epoch=1)
    assert [name for name, _ in terms] == [name for name, _ in jterms]
    names = [name for name, _ in terms]
    assert ("transh.soft_constraints_ent" in names) == (weight > 0)
    for (_, got), (_, want) in zip(terms, jterms):
        np.testing.assert_allclose(float(got.detach()), float(want), rtol=1e-5)
    tables = [tmodel.get_s_embedder().embeddings, tmodel.get_p_embedder().embeddings]
    grads = torch.autograd.grad(sum(v for _, v in terms), tables)
    for g, key in zip(grads, ("entity_embedder", "relation_embedder")):
        np.testing.assert_allclose(
            g.numpy(), np.asarray(jgrads[key]["embeddings"]), rtol=1e-5, atol=1e-6)


def test_rotate_checks_and_phase_normalization():
    config = make_config(kge_tpu_torch, "dataset_test",
                         {"model": "rotate", "lookup_embedder.dim": 7})
    dataset = kge_tpu_torch.Dataset.create(config, folder=str(DATASET_DIR))
    with pytest.raises(ValueError, match="even"):
        kge_tpu_torch.models.KgeModel.create(config, dataset)
    config = make_config(kge_tpu_torch, "dataset_test",
                         {"model": "rotate", "lookup_embedder.dim": 8})
    model = kge_tpu_torch.models.KgeModel.create(config, dataset)
    model.init_params(torch.Generator().manual_seed(0))
    phases = model.get_p_embedder().embeddings.detach()
    # the phase initializer: uniform on [-pi, pi)
    assert float(phases.min()) >= -np.pi and float(phases.max()) < np.pi
    assert float(phases.abs().max()) > 1.5
    t = torch.tensor([[0, 1, 2], [3, 2, 4]])
    with torch.no_grad():
        phases.add_(torch.tensor([[7.0], [-9.0], [2 * np.pi]]))
        before = model.score_spo(t[:, 0], t[:, 1], t[:, 2])
        model.postprocess_params()
        assert float(phases.min()) >= -np.pi and float(phases.max()) < np.pi
        # the same rotations: scores are unchanged
        np.testing.assert_allclose(
            model.score_spo(t[:, 0], t[:, 1], t[:, 2]).numpy(), before.numpy(),
            rtol=1e-5, atol=1e-5)


# -- where auto resolves --------------------------------------------------------


@pytest.mark.parametrize("model", ["transe", "rotate"])
@pytest.mark.parametrize("extra,resolved", [
    ({}, "pool"),
    ({"negative_sampling.auto_exact": True}, "triple"),
    ({"negative_sampling.filtering.o": True}, "triple"),
    ({"negative_sampling.on_device": "never"}, "triple"),
    ({"negative_sampling.shared": True}, "triple"),
])
def test_auto_resolves_as_in_kge_tpu(model, extra, resolved):
    from kge_tpu.job import TrainingJob as JaxTrainingJob
    from kge_tpu_torch.job import TrainingJob

    options = pooled_options(model, **extra)
    jconfig = make_config(kge_tpu, "dataset_test", options)
    jconfig.set("parallel.data", 1)
    jconfig.set("parallel.model", 1)
    jjob = JaxTrainingJob.create(
        jconfig, kge_tpu.Dataset.create(jconfig, folder=str(DATASET_DIR)))
    jjob._prepare()
    assert jjob._implementation == resolved
    tconfig = make_config(kge_tpu_torch, "dataset_test", options)
    tjob = TrainingJob.create(
        tconfig, kge_tpu_torch.Dataset.create(tconfig, folder=str(DATASET_DIR)))
    tjob._prepare()
    assert tjob._implementation == resolved
    assert tjob._on_device == jjob._on_device


@pytest.mark.parametrize("model,extra,resolved", [
    # L2 factorizes: the standard ladder, which prefers pool as well
    ("transe_l2", {}, "pool"),
    ("transe_l2", {"negative_sampling.on_device": "never"}, "all"),
    ("transe_l2", {"negative_sampling.shared": True}, "batch"),
    ("transh", {}, "pool"),
    ("transh", {"negative_sampling.filtering.o": True}, "triple"),
])
def test_auto_resolves_for_l2_and_transh_as_in_kge_tpu(model, extra, resolved):
    from kge_tpu.job import TrainingJob as JaxTrainingJob
    from kge_tpu_torch.job import TrainingJob

    name, variant = VARIANTS.get(model, (model, {}))
    options = pooled_options(name, **variant, **extra)
    jconfig = make_config(kge_tpu, "dataset_test", options)
    jconfig.set("parallel.data", 1)
    jconfig.set("parallel.model", 1)
    jjob = JaxTrainingJob.create(
        jconfig, kge_tpu.Dataset.create(jconfig, folder=str(DATASET_DIR)))
    jjob._prepare()
    assert jjob._implementation == resolved
    tconfig = make_config(kge_tpu_torch, "dataset_test", options)
    tjob = TrainingJob.create(
        tconfig, kge_tpu_torch.Dataset.create(tconfig, folder=str(DATASET_DIR)))
    if resolved == "all":
        # the same resolution, then the refusal of an unported implementation
        with pytest.raises(NotImplementedError, match="ROADMAP.md section A.2"):
            tjob._prepare()
        assert tjob._implementation == "all"
        return
    tjob._prepare()
    assert tjob._implementation == resolved


# -- trajectories ---------------------------------------------------------------

STEPS = 5

TRAJECTORIES = [
    # (name, model, options, table atol, state atol)
    ("transe_dense", "transe", {"train.sparse_embedding_update": "never"},
     5e-6, 1e-5),
    ("transe_sparse", "transe", {"train.sparse_embedding_update": "always"},
     5e-6, 1e-5),
    ("transe_p_slot", "transe", {"negative_sampling.num_samples.p": 4},
     5e-6, 1e-5),
    ("rotate_dense", "rotate", {"train.sparse_embedding_update": "never"},
     2e-6, 1e-6),
    ("rotate_sparse", "rotate", {"train.sparse_embedding_update": "always"},
     2e-6, 1e-6),
    ("rotate_p_slot_sparse", "rotate",
     {"train.sparse_embedding_update": "always",
      "negative_sampling.num_samples.p": 4}, 2e-6, 1e-6),
    ("rotate_kernel_route", "rotate",
     {"negative_sampling.pooled_kernel": "always"}, 2e-6, 1e-6),
    ("rotate_adamw_sparse", "rotate",
     {"train.sparse_embedding_update": "always",
      "train.optimizer.default.type": "AdamW",
      "train.optimizer.default.args.weight_decay": 0.01}, 2e-6, 1e-6),
    ("transh_dense", "transh", {"transh.C": 0.1}, 5e-6, 1e-5),
    ("transh_p_slot_sparse", "transh",
     {"train.sparse_embedding_update": "always",
      "negative_sampling.num_samples.p": 4}, 5e-6, 1e-5),
]


@pytest.mark.parametrize("name,model,extra,table_atol,state_atol", TRAJECTORIES,
                         ids=[c[0] for c in TRAJECTORIES])
def test_trajectory_matches_jax(name, model, extra, table_atol, state_atol):
    """Five steps from the same weights, batches, pools and selections. On
    the row-sparse step kge_tpu gives Adam's tables its fused kernel (or, at
    this width, that kernel's dense formulation), the port
    ``fused_sorted_update``."""
    options = pooled_options(model, **extra)
    if model != "rotate":
        options["train.optimizer.default.args.initial_accumulator_value"] = 0.1
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", options)
    assert tjob._implementation == jjob._implementation == "pool"
    assert tjob._sparse_update == jjob._sparse_update == (
        extra.get("train.sparse_embedding_update") == "always")
    start = [t.copy() for t in _tables(tjob)]
    for want, got in _run_steps(jjob, tjob):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    for got, want in zip(_tables(tjob), _jax_tables(jjob)):
        np.testing.assert_allclose(got, want, atol=table_atol, rtol=0)
    for got, want in zip(tjob.opt_state["leaves"], jjob.opt_state["leaves"]):
        assert sorted(got) == sorted(want)
        for key in want:
            np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]),
                                       atol=state_atol, rtol=0)
    assert int(tjob.opt_state["step"]) == int(jjob.opt_state["step"]) == STEPS
    moved = max(np.abs(a - b).max() for a, b in zip(_tables(tjob), start))
    assert moved > (1e-3 if model == "rotate" else 1e-2)
    if model == "rotate":
        phases = _tables(tjob)[1]
        assert phases.min() >= -np.pi and phases.max() < np.pi


def test_pool_drawn_on_the_device():
    """The pool draw: ``num * pool_factor`` ids of the slot's vocabulary and
    selections in [0, pool_factor), the same from the same seed; an epoch
    through ``run_epoch`` learns."""
    from kge_tpu_torch.job import TrainingJob

    def job():
        config = make_config(kge_tpu_torch, "dataset_test", pooled_options(
            "transe", **{"negative_sampling.num_samples.p": 2}))
        dataset = kge_tpu_torch.Dataset.create(config, folder=str(DATASET_DIR))
        job = TrainingJob.create(config, dataset)
        job._prepare()
        job._is_prepared = True
        return job

    a, b = job(), job()
    triples = torch.tensor(a.dataset.split("train")[:6].astype(np.int64))
    for slot, num, vocab in ((0, 4, 7), (1, 2, 3), (2, 4, 7)):
        drawn = a._draw_negatives_on_device(triples, slot)
        pool, sel = drawn[f"neg_pool_{slot}"], drawn[f"neg_sel_{slot}"]
        assert pool.shape == (num * 3,) and sel.shape == (6, num)
        assert 0 <= int(pool.min()) and int(pool.max()) < vocab
        assert 0 <= int(sel.min()) and int(sel.max()) < 3
        again = b._draw_negatives_on_device(triples, slot)
        assert torch.equal(again[f"neg_pool_{slot}"], pool)
        assert torch.equal(again[f"neg_sel_{slot}"], sel)
    losses = []
    for epoch in range(1, 6):
        a.epoch = epoch
        losses.append(a.run_epoch()["avg_loss"])
    assert np.isfinite(losses).all() and losses[-1] < losses[0]


@pytest.mark.parametrize("model", ["transe", "rotate", "transh"])
def test_config_keys_equal_kge_tpus(model):
    """The port's configuration of a distance model has exactly kge_tpu's
    keys, so that a folder written by either package loads in the other."""

    def flat(options, prefix=""):
        keys = set()
        for key, value in options.items():
            if isinstance(value, dict) and value:
                keys |= flat(value, prefix + key + ".")
            else:
                keys.add(prefix + key)
        return keys

    theirs, ours = kge_tpu.Config(), kge_tpu_torch.Config()
    for config in (theirs, ours):
        config.load_options({"model": model})
    assert flat(ours.options) == flat(theirs.options)
    assert ours.get(f"{model}.l_norm") == theirs.get(f"{model}.l_norm") == 1.0
