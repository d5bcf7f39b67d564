"""Pretrained initialization (``<embedder>.pretrain.model_filename``) of
kge_tpu_torch against kge_tpu on the CPU.

Sources are checkpoints of one-epoch toy runs (examples/toy-complex-train.yaml
on dataset_test) written by kge_tpu, by the port, and by the port under
``parallel.compute_dtype: bfloat16``. A model built in each package with the
same pretrain setting initializes its table from the source: rows are
matched by external id, read through the source model's ``embed`` in eval
mode (its compute dtype) and cast into the new table's dtype. The table
equals kge_tpu's bit for bit, for the entity and the relation embedder and a
float32 or bfloat16 target. A target whose ids the source covers in part
takes the common rows, and with ``ensure_all`` both packages raise.
"""

import sys

import jax
import numpy as np
import pytest
import torch

import kge_tpu
import kge_tpu_torch
from kge_tpu.models import KgeModel as JaxModel
from kge_tpu_torch.models import KgeModel as TorchModel
from kge_tpu_torch.models.convert import leaf_tensor
from kge_tpu_torch.utils.io import load_checkpoint
from tests.test_torch_cli import EXAMPLES_DIR, _run, _toy_cwd
from tests.torch_parity import make_config
from tests.util import make_synthetic_dataset

TOY = str(EXAMPLES_DIR / "toy-complex-train.yaml")


@pytest.fixture(scope="module")
def sources(tmp_path_factory):
    """(working directory, {name: checkpoint_best.pt}) of one-epoch toy runs
    by kge_tpu ("jax"), the port ("torch") and the port with bfloat16
    compute ("torch_bf16")."""
    cwd = _toy_cwd(tmp_path_factory.mktemp("torch_pretrained"))
    runs = {
        "jax": ("kge_tpu", []),
        "torch": ("kge_tpu_torch", ["--job.device", "cpu"]),
        "torch_bf16": ("kge_tpu_torch", ["--job.device", "cpu",
                                         "--parallel.compute_dtype", "bfloat16"]),
    }
    files = {}
    for name, (package, extra) in runs.items():
        folder = cwd / name
        _run([sys.executable, "-m", package, "start", TOY, *extra,
              "--train.max_epochs", "1", "--valid.every", "1",
              "--folder", str(folder)], cwd=cwd)
        files[name] = folder / "checkpoint_best.pt"
        assert files[name].exists()
    return cwd, files


def _models(folder, dataset_name, options, seed=0):
    """(kge_tpu's initial parameters, the port's initialized model)."""
    jconfig = make_config(kge_tpu, dataset_name, options)
    jdataset = kge_tpu.Dataset.create(jconfig, folder=str(folder))
    params = JaxModel.create(jconfig, jdataset).init_params(
        jax.random.PRNGKey(seed))
    tconfig = make_config(kge_tpu_torch, dataset_name, options)
    tdataset = kge_tpu_torch.Dataset.create(tconfig, folder=str(folder))
    tmodel = TorchModel.create(tconfig, tdataset)
    tmodel.init_params(torch.Generator().manual_seed(seed))
    return params, tmodel


def _table(params, tmodel, embedder):
    """(kge_tpu's table, the port's) as (dtype name, float32 numpy)."""
    want = np.asarray(params[embedder]["embeddings"])
    got = (tmodel.get_s_embedder() if embedder == "entity_embedder"
           else tmodel.get_p_embedder()).embeddings.detach()
    return ((str(want.dtype), want.astype(np.float32)),
            (str(got.dtype).replace("torch.", ""), got.float().numpy()))


@pytest.mark.parametrize("target", ["float32", "bfloat16"])
@pytest.mark.parametrize("embedder", ["entity_embedder", "relation_embedder"])
@pytest.mark.parametrize("source", ["jax", "torch", "torch_bf16"])
def test_pretrained_table_equals_kge_tpus(sources, monkeypatch, source,
                                          embedder, target):
    cwd, files = sources
    monkeypatch.chdir(cwd)
    options = {
        "model": "complex", "lookup_embedder.dim": 32,
        f"complex.{embedder}.pretrain.model_filename": str(files[source]),
        "parallel.param_dtype": target,
    }
    params, tmodel = _models(cwd / "data" / "dataset_test", "dataset_test",
                             options)
    (jdtype, want), (tdtype, got) = _table(params, tmodel, embedder)
    assert tdtype == jdtype == target
    np.testing.assert_array_equal(got, want)
    # every row came from the source, through its embed: in bfloat16 where
    # the source computes in bfloat16
    ckpt = load_checkpoint(str(files[source]))
    rows = leaf_tensor(
        ckpt["model"][0][embedder]["embeddings"]).float()
    if source == "torch_bf16" or target == "bfloat16":
        rows = rows.bfloat16().float()
    np.testing.assert_array_equal(got, rows.numpy())


@pytest.fixture(scope="module")
def wider(tmp_path_factory):
    """64 entities e0..e63, of which the toy source holds e0..e6."""
    return make_synthetic_dataset(
        tmp_path_factory.mktemp("pretrained_wider") / "pretrained_synth",
        num_entities=64, num_relations=3, num_train=200, seed=3)


def test_partial_cover_takes_the_common_rows(sources, wider, monkeypatch):
    cwd, files = sources
    monkeypatch.chdir(cwd)
    options = {
        "model": "complex", "lookup_embedder.dim": 32,
        "complex.entity_embedder.pretrain.model_filename": str(files["jax"]),
    }
    params, tmodel = _models(wider, wider.name, options)
    (_, want), (_, got) = _table(params, tmodel, "entity_embedder")
    source = kge_tpu_torch.Dataset.create(
        make_config(kge_tpu_torch, "dataset_test", {"model": "complex"}),
        folder=str(cwd / "data" / "dataset_test"))
    common = [i for i, e in enumerate(tmodel.dataset.entity_ids())
              if e in set(source.entity_ids())]
    assert 0 < len(common) < 64
    np.testing.assert_array_equal(got[common], want[common])


@pytest.mark.parametrize("package", [kge_tpu, kge_tpu_torch],
                         ids=["kge_tpu", "kge_tpu_torch"])
def test_ensure_all_raises_as_kge_tpu_raises(sources, wider, monkeypatch,
                                             package):
    cwd, files = sources
    monkeypatch.chdir(cwd)
    options = {
        "model": "complex", "lookup_embedder.dim": 32,
        "complex.entity_embedder.pretrain.model_filename": str(files["torch"]),
        "complex.entity_embedder.pretrain.ensure_all": True,
    }
    config = make_config(package, wider.name, options)
    dataset = package.Dataset.create(config, folder=str(wider))
    if package is kge_tpu:
        model = JaxModel.create(config, dataset)
        init = lambda: model.init_params(jax.random.PRNGKey(0))  # noqa: E731
    else:
        model = TorchModel.create(config, dataset)
        init = lambda: model.init_params(torch.Generator())  # noqa: E731
    with pytest.raises(ValueError,
                       match=r"pretrained embedder does not cover all ids "
                             r"\(7 of 64\)"):
        init()
