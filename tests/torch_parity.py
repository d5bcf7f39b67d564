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


def train_options(**extra):
    """Options of a toy shared-negative ComplEx training job (d = 8, batch 6,
    Adagrad lr 0.1, KL loss), the small counterpart of the port's main
    training path."""
    options = {
        "model": "complex",
        "lookup_embedder.dim": 8,
        "train.type": "negative_sampling",
        "train.batch_size": 6,
        "train.loss": "kl",
        "train.optimizer.default.type": "Adagrad",
        "train.optimizer.default.args.lr": 0.1,
        "negative_sampling.shared": True,
        "negative_sampling.num_samples.s": 4,
        "negative_sampling.num_samples.o": -1,
        "valid.every": 0,
    }
    options.update(extra)
    return options


def make_job_pair(folder, dataset_name, options):
    """(jax_job, torch_job), both prepared, the torch job's model holding
    the jax job's initial weights."""
    from kge_tpu.job import TrainingJob as JaxTrainingJob
    from kge_tpu_torch.job import TrainingJob as TorchTrainingJob

    jconfig = make_config(kge_tpu, dataset_name, options)
    jconfig.set("parallel.data", 1)
    jconfig.set("parallel.model", 1)
    jdataset = kge_tpu.Dataset.create(jconfig, folder=str(folder))
    jjob = JaxTrainingJob.create(jconfig, jdataset)
    jjob._prepare()
    jjob._is_prepared = True

    tconfig = make_config(kge_tpu_torch, dataset_name, options)
    tdataset = kge_tpu_torch.Dataset.create(tconfig, folder=str(folder))
    tmodel = TorchModel.create(tconfig, tdataset, init_for_load_only=True)
    load_jax_params(tmodel, jax.tree_util.tree_map(np.asarray, jjob.model_params))
    tjob = TorchTrainingJob.create(tconfig, tdataset, model=tmodel)
    tjob._prepare()
    tjob._is_prepared = True
    return jjob, tjob


def shared_negatives(rng, triples, slots, num, vocab_sizes):
    """Shared negatives for one batch as numpy arrays, in the form both
    packages take pre-drawn: per slot ``num + 1`` draws, and each row's
    first match with its own positive among the first ``num``."""
    out = {}
    for slot in slots:
        sample = rng.integers(0, vocab_sizes[slot], num + 1)
        matches = sample[None, :num] == triples[:, slot][:, None]
        out[f"neg_unique_{slot}"] = sample.astype(np.int64)
        out[f"neg_first_{slot}"] = np.argmax(matches, axis=1).astype(np.int64)
        out[f"neg_hasmatch_{slot}"] = matches.any(axis=1)
    return out
