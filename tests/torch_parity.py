"""Helpers for the tests that hold kge_tpu_torch against kge_tpu: one set of
options builds a config, a dataset and a model in each package, and kge_tpu's
weights are carried across through numpy."""

import jax
import numpy as np

import kge_tpu
import kge_tpu_torch
from kge_tpu.models import KgeModel as JaxModel
from kge_tpu_torch.models import KgeModel as TorchModel, load_jax_params


def model_options(model: str, dim: int = 32):
    if model == "reciprocal_complex":
        return {
            "model": "reciprocal_relations_model",
            "reciprocal_relations_model.base_model.type": "complex",
            "lookup_embedder.dim": dim,
        }
    return {"model": model, "lookup_embedder.dim": dim}


def make_config(package, dataset_name: str, options):
    config = package.Config()
    config.set("console.quiet", True)
    config.set("job.device", "cpu")
    config.set("random_seed.default", 0)
    config.set("dataset.name", dataset_name)
    config.load_options({"model": options["model"]})
    for key, value in options.items():
        if key != "model":
            config.set(key, value, create=True)
    return config


def make_pair(folder, dataset_name, options, seed=0):
    """(jax_model, jax_params, torch_model) with the same weights."""
    jconfig = make_config(kge_tpu, dataset_name, options)
    jdataset = kge_tpu.Dataset.create(jconfig, folder=str(folder))
    jmodel = JaxModel.create(jconfig, jdataset)
    params = jmodel.init_params(jax.random.PRNGKey(seed))
    params = jax.tree_util.tree_map(np.asarray, params)

    tconfig = make_config(kge_tpu_torch, dataset_name, options)
    tdataset = kge_tpu_torch.Dataset.create(tconfig, folder=str(folder))
    tmodel = TorchModel.create(tconfig, tdataset, init_for_load_only=True)
    load_jax_params(tmodel, params)
    return jmodel, params, tmodel
