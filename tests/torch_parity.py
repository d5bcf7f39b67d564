"""Helpers for the tests that hold kge_tpu_torch against kge_tpu: one set of
options builds a config, a dataset and a model in each package, and kge_tpu's
weights are carried across through numpy."""

import jax
import jax.numpy as jnp
import numpy as np
import torch

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


def pooled_options(model, **extra):
    """Options of a toy pooled-negative training job of a distance model (d =
    8, batch 6, 4 negatives per slot from pools of 4 x 3 candidates):
    TransE-L1 with margin ranking and Adagrad, RotatE-L1 with self-adversarial
    BCE and Adam, the small counterparts of the port's pooled paths."""
    options = {
        "model": model,
        "lookup_embedder.dim": 8,
        "train.type": "negative_sampling",
        "train.batch_size": 6,
        "negative_sampling.shared": False,
        "negative_sampling.implementation": "auto",
        "negative_sampling.num_samples.s": 4,
        "negative_sampling.num_samples.o": -1,
        "negative_sampling.pool_factor": 3,
        "valid.every": 0,
    }
    if model == "rotate":
        options.update({
            "train.loss": "bce_self_adversarial",
            "train.optimizer.default.type": "Adam",
            "train.optimizer.default.args.lr": 0.001,
        })
    else:
        options.update({
            "train.loss": "margin_ranking",
            "train.loss_arg": 4.0,
            "train.optimizer.default.type": "Adagrad",
            "train.optimizer.default.args.lr": 0.1,
        })
    options.update(extra)
    return options


def pooled_negatives(rng, triples, slots, num, vocab_sizes, pool_factor):
    """Pooled negatives for one batch as numpy arrays, in the form both
    packages take pre-drawn: per slot a pool of ``num * pool_factor`` ids and
    each row's choice within every group of ``pool_factor``."""
    out = {}
    for slot in slots:
        out[f"neg_pool_{slot}"] = rng.integers(
            0, vocab_sizes[slot], num * pool_factor).astype(np.int64)
        out[f"neg_sel_{slot}"] = rng.integers(
            0, pool_factor, (len(triples), num)).astype(np.int64)
    return out


def per_row_negatives(rng, triples, slots, num, vocab_sizes):
    """Per-row negatives for one batch: [n, num] ids per slot."""
    return {
        f"neg_samples_{slot}": rng.integers(
            0, vocab_sizes[slot], (len(triples), num)).astype(np.int64)
        for slot in slots
    }


def torch_tables(job):
    return [p.detach().numpy() for p in job.optimizer.params]


def jax_tables(job):
    return [np.asarray(job.model_params[k]["embeddings"])
            for k in ("entity_embedder", "relation_embedder")]


def run_steps(jjob, tjob, steps=5, seed=3):
    """The same ``steps`` batches with the same pre-drawn negatives (of the
    kind the jobs' implementation scores) through both jobs' raw train
    steps; returns the per-step (jax loss, torch loss)."""
    rng = np.random.default_rng(seed)
    slots = jjob._active_slots
    assert tjob._active_slots == slots
    vocab = [int(v) for v in jjob._sampler.vocabulary_size]
    num = int(jjob._sampler.num_samples[slots[0]])
    losses = []
    batches = list(jjob._batches())
    for step in range(steps):
        batch = batches[step % len(batches)]
        triples = batch["triples"].astype(np.int64)
        arrays = {"triples": triples, "mask": batch["mask"]}
        if jjob._implementation == "pool":
            arrays.update(pooled_negatives(rng, triples, slots, num, vocab,
                                           jjob._pool_factor))
        elif jjob._implementation == "triple":
            arrays.update(per_row_negatives(rng, triples, slots, num, vocab))
        else:
            arrays.update(shared_negatives(rng, triples, slots, num, vocab))
        jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                  for k, v in arrays.items()}
        jjob.model_params, jjob.opt_state, _, jaux = jjob._raw_step(
            jjob.model_params, jjob.opt_state, jbatch, jax.random.PRNGKey(step),
            jjob._current_lrs()
        )
        tbatch = {k: torch.tensor(v) for k, v in arrays.items()}
        _, taux = tjob._train_step(tbatch, tjob._current_lrs())
        losses.append((float(jaux["avg_loss"]), float(taux["avg_loss"])))
    return losses
