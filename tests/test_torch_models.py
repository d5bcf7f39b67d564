"""ComplEx and reciprocal ComplEx of kge_tpu_torch against kge_tpu at d=32,
with kge_tpu's weights carried across (models/convert.py). Scores agree
within rtol 1e-5, atol 1e-5: the same float32 products, summed by two
libraries in different orders."""

import numpy as np
import pytest
import torch

from kge_tpu_torch.models import (
    ComplEx,
    ReciprocalRelationsModel,
    to_jax_params,
)
from kge_tpu_torch.utils.io import load_checkpoint
from tests.torch_parity import make_pair, model_options
from tests.util import make_synthetic_dataset

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(autouse=True)
def _no_grad():
    with torch.no_grad():
        yield


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(
        tmp_path_factory.mktemp("torch_models") / "models_synth",
        num_entities=60, num_relations=5, num_train=400, num_valid=20,
        num_test=20, seed=3,
    )


def _triples(n, E, R, seed):
    rng = np.random.default_rng(seed)
    return np.stack(
        [rng.integers(0, E, n), rng.integers(0, R, n), rng.integers(0, E, n)],
        axis=1,
    ).astype(np.int32)


@pytest.mark.parametrize("model", ["complex", "reciprocal_complex"])
def test_scores_match_kge_tpu(synth, model):
    jmodel, params, tmodel = make_pair(synth, "models_synth", model_options(model))
    expected_type = ComplEx if model == "complex" else ReciprocalRelationsModel
    assert type(tmodel) is expected_type
    t = _triples(17, 60, 5, seed=1)
    s, p, o = (t[:, i] for i in range(3))
    ts, tp, to = (torch.from_numpy(x) for x in (s, p, o))
    directions = [None] if model == "complex" else ["o", "s"]
    for d in directions:
        np.testing.assert_allclose(
            tmodel.score_spo(ts, tp, to, d).numpy(),
            np.asarray(jmodel.score_spo(params, s, p, o, d)), **TOL,
        )
    np.testing.assert_allclose(
        tmodel.score_sp(ts, tp).numpy(),
        np.asarray(jmodel.score_sp(params, s, p)), **TOL,
    )
    np.testing.assert_allclose(
        tmodel.score_po(tp, to).numpy(),
        np.asarray(jmodel.score_po(params, p, o)), **TOL,
    )
    subset = np.arange(5, 40, dtype=np.int32)
    np.testing.assert_allclose(
        tmodel.score_sp(ts, tp, torch.from_numpy(subset)).numpy(),
        np.asarray(jmodel.score_sp(params, s, p, subset)), **TOL,
    )
    np.testing.assert_allclose(
        tmodel.score_sp_po(ts, tp, to, torch.from_numpy(subset)).numpy(),
        np.asarray(jmodel.score_sp_po(params, s, p, o, subset)), **TOL,
    )


@pytest.mark.parametrize("model", ["complex", "reciprocal_complex"])
def test_factorized_queries_score_like_the_scoring_api(synth, model):
    """query . targets reproduces score_sp (slot 2) and score_po (slot 0);
    pos is the per-direction spo score."""
    _, _, tmodel = make_pair(synth, "models_synth", model_options(model))
    t = torch.from_numpy(_triples(9, 60, 5, seed=2)).long()
    fac = tmodel.factorized_queries(t, (0, 2))
    pos, q, targets, smap = fac[2]
    assert smap is None
    np.testing.assert_allclose((q @ targets.T).numpy(),
                               tmodel.score_sp(t[:, 0], t[:, 1]).numpy(), **TOL)
    pos0, q0, targets0, _ = fac[0]
    np.testing.assert_allclose((q0 @ targets0.T).numpy(),
                               tmodel.score_po(t[:, 1], t[:, 2]).numpy(), **TOL)
    direction = None if model == "complex" else "s"
    np.testing.assert_allclose(
        pos0.numpy(),
        tmodel.score_spo(t[:, 0], t[:, 1], t[:, 2], direction).numpy(), **TOL,
    )


def test_weights_round_trip_and_shape_check(synth):
    _, params, tmodel = make_pair(
        synth, "models_synth", model_options("reciprocal_complex")
    )
    back = to_jax_params(tmodel)
    assert back["relation_embedder"]["embeddings"].shape == (10, 32)
    for key in ("entity_embedder", "relation_embedder"):
        np.testing.assert_array_equal(
            back[key]["embeddings"], params[key]["embeddings"]
        )
    from kge_tpu_torch.models import load_jax_params

    bad = {k: dict(v) for k, v in params.items()}
    bad["relation_embedder"]["embeddings"] = np.zeros((5, 32), np.float32)
    with pytest.raises(ValueError):
        load_jax_params(tmodel, bad)


def test_create_from_kge_tpu_checkpoint(synth, tmp_path):
    """A checkpoint in kge_tpu's schema, pickling kge_tpu's Config, loads
    into the port's model without importing anything of kge_tpu beyond
    what the test process already holds."""
    import pickle

    import kge_tpu
    from kge_tpu_torch.models import KgeModel
    from tests.torch_parity import make_config

    options = model_options("reciprocal_complex")
    config = make_config(kge_tpu, "models_synth", options)
    dataset = kge_tpu.Dataset.create(config, folder=str(synth))
    _, params, _ = make_pair(synth, "models_synth", options)
    checkpoint = {"type": "train", "epoch": 3, "model": (params, {}),
                  "job_id": "x" * 36}
    config.save_to(checkpoint)
    dataset.save_to(checkpoint)
    path = tmp_path / "checkpoint_00003.pt"
    with open(path, "wb") as f:
        pickle.dump(checkpoint, f)
    loaded = load_checkpoint(str(path))
    assert type(loaded["config"]).__module__ == "kge_tpu_torch.config"
    assert all(m.startswith("kge_tpu_torch") for m in loaded["config"].get("modules"))
    loaded["config"].set("dataset.name", str(synth))
    model = KgeModel.create_from(loaded)
    assert type(model) is ReciprocalRelationsModel
    np.testing.assert_array_equal(
        model.get_p_embedder().embeddings.detach().numpy(),
        params["relation_embedder"]["embeddings"],
    )


@pytest.mark.parametrize("initialize,args,check", [
    ("normal_", {"std": 0.1}, lambda w: abs(float(w.std()) - 0.1) < 0.02),
    ("uniform_", {"b": 0.3}, lambda w: float(w.abs().max()) <= 0.3),
    ("xavier_uniform_", {}, lambda w: float(w.abs().max()) <= (6 / (60 + 32)) ** 0.5),
    ("xavier_normal_", {}, lambda w: float(w.std()) > 0),
    ("kaiming_uniform_", {}, lambda w: float(w.abs().max()) <= (6 / 32) ** 0.5),
    ("constant_", {"val": 0.5}, lambda w: bool((w == 0.5).all())),
])
def test_init_params_from_generator(synth, initialize, args, check):
    """Initialization draws from an explicit torch.Generator: the same seed
    gives the same weights; the configured initializer sets their range."""
    import kge_tpu_torch
    from kge_tpu_torch.models import KgeModel
    from tests.torch_parity import make_config

    options = {**model_options("complex"),
               "lookup_embedder.initialize": initialize,
               f"lookup_embedder.initialize_args.{initialize}": args}
    config = make_config(kge_tpu_torch, "models_synth", options)
    dataset = kge_tpu_torch.Dataset.create(config, folder=str(synth))
    weights = []
    for seed in (7, 7, 8):
        model = KgeModel.create(config, dataset)
        model.init_params(torch.Generator().manual_seed(seed))
        weights.append(model.get_s_embedder().embeddings.detach().clone())
    assert check(weights[0])
    assert torch.equal(weights[0], weights[1])
    assert initialize == "constant_" or not torch.equal(weights[0], weights[2])


def test_normalize_renormalizes_rows(synth):
    import kge_tpu_torch
    from kge_tpu_torch.models import KgeModel
    from tests.torch_parity import make_config

    options = {**model_options("complex"), "lookup_embedder.normalize.p": 2.0}
    config = make_config(kge_tpu_torch, "models_synth", options)
    dataset = kge_tpu_torch.Dataset.create(config, folder=str(synth))
    model = KgeModel.create(config, dataset)
    model.init_params(torch.Generator().manual_seed(0))
    norms = torch.linalg.vector_norm(model.get_s_embedder().embeddings, dim=1)
    torch.testing.assert_close(norms, torch.ones_like(norms))
