"""Subbatched steps (``train.subbatch_size``) and out-of-memory handling
(``train.subbatch_auto_tune``) of kge_tpu_torch against kge_tpu on the CPU.

A subbatched step of negative sampling, 1vsAll and KvsAll against
kge_tpu's subbatched step (its scan over subbatches) and against the port's
own unsubbatched step, from the same weights, batches and injected
negatives: losses rtol 1e-5, tables atol 5e-6, optimizer state atol 1e-5
(Adagrad from an accumulator of 0.1, as in test_torch_train.py). Then
kge_tpu's refusal of a subbatch size that does not divide the batch, the
trace keys of a subbatched epoch, and ``_handle_oom`` with an out-of-memory
error injected before and after the optimizer's first write.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import kge_tpu
from kge_tpu.ops import pallas_ops
from kge_tpu_torch.ops import embedding_ops
from tests.test_torch_train_1vsall_kvsall import QUERY_TYPES
from tests.test_torch_train_1vsall_kvsall import options as all_options
from tests.torch_parity import (
    assert_same_state,
    make_job_pair,
    pooled_options,
    run_batch_steps,
    run_steps,
    shared_negatives,
    torch_tables,
    train_options,
)
from tests.util import DATASET_DIR, make_synthetic_dataset

SYNTH = "subbatch_synth"
ACC = {"train.optimizer.default.args.initial_accumulator_value": 0.1}


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    pallas_ops.set_gather_mode("xla")
    embedding_ops.set_gather_mode("torch")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(tmp_path_factory.mktemp("subbatch") / SYNTH,
                                  num_entities=64, num_relations=8, num_train=512,
                                  seed=11)


NEGATIVE_SAMPLING = [
    # (name, options); batch 6
    ("shared", train_options(**ACC)),
    ("shared-penalty", train_options(**ACC, **{
        "lookup_embedder.regularize_weight": 0.01})),
    ("all", train_options(**ACC, **{"negative_sampling.shared": False,
                                    "negative_sampling.implementation": "all"})),
    ("batch", train_options(**ACC, **{"negative_sampling.shared": False,
                                      "negative_sampling.implementation": "batch"})),
    ("pool-transe", pooled_options("transe", **ACC)),
    ("triple-transe", pooled_options("transe", **ACC, **{
        "negative_sampling.implementation": "triple"})),
    ("fused", train_options(**ACC, **{"negative_sampling.fused_scoring": "always"})),
]


def _with(options, **extra):
    return {**options, **extra}


@pytest.mark.parametrize("sub", [2, 3])
@pytest.mark.parametrize("name,options", NEGATIVE_SAMPLING,
                         ids=[c[0] for c in NEGATIVE_SAMPLING])
def test_negative_sampling_subbatches_match_kge_tpu(name, options, sub):
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test",
                               _with(options, **{"train.subbatch_size": sub}))
    assert not tjob._sparse_update and not jjob._sparse_update
    for want, got in run_steps(jjob, tjob):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_same_state(jjob, tjob)


@pytest.mark.parametrize("name,options", NEGATIVE_SAMPLING,
                         ids=[c[0] for c in NEGATIVE_SAMPLING])
def test_negative_sampling_subbatches_equal_the_whole_batch(name, options):
    """The port's subbatched step (subbatches of 2) and its unsubbatched
    step, from the same weights and negatives: the penalty counted once."""
    jjob, whole = make_job_pair(DATASET_DIR, "dataset_test", options)
    _, parts = make_job_pair(DATASET_DIR, "dataset_test",
                             _with(options, **{"train.subbatch_size": 2}))
    rng = np.random.default_rng(5)
    batch = next(iter(jjob._batches()))
    triples = batch["triples"].astype(np.int64)
    arrays = {"triples": triples, "mask": batch["mask"]}
    slots, num = jjob._active_slots, int(jjob._sampler.num_samples[0])
    vocab = [int(v) for v in jjob._sampler.vocabulary_size]
    if jjob._implementation == "pool":
        arrays.update({f"neg_pool_{s}": rng.integers(0, vocab[s], num * 3)
                       for s in slots})
        arrays.update({f"neg_sel_{s}": rng.integers(0, 3, (6, num)) for s in slots})
    elif jjob._sampler.shared:
        arrays.update(shared_negatives(rng, triples, slots, num, vocab))
    else:
        arrays.update({f"neg_samples_{s}": rng.integers(0, vocab[s], (6, num))
                       for s in slots})
    results = []
    for job in (whole, parts):
        cost, aux = job._train_step({k: torch.tensor(v) for k, v in arrays.items()},
                                    job._current_lrs())
        results.append((float(cost), float(aux["avg_loss"]), aux))
    np.testing.assert_allclose(results[1][0], results[0][0], rtol=1e-5)
    np.testing.assert_allclose(results[1][1], results[0][1], rtol=1e-5)
    assert sorted(results[1][2]) == ["avg_loss", "penalties"]
    assert sorted(results[1][2]["penalties"]) == sorted(results[0][2]["penalties"])
    for a, b in zip(torch_tables(whole), torch_tables(parts)):
        np.testing.assert_allclose(a, b, atol=5e-6, rtol=0)


@pytest.mark.parametrize("sub", [1, 3])
@pytest.mark.parametrize("model", ["complex", "reciprocal_complex"])
def test_1vsall_subbatches_match_kge_tpu(model, sub):
    extra = {"train.subbatch_size": sub}
    if model == "reciprocal_complex":
        extra.update({"model": "reciprocal_relations_model",
                      "reciprocal_relations_model.base_model.type": "complex"})
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", all_options("1vsAll", **extra))
    for want, got in run_batch_steps(jjob, tjob):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_same_state(jjob, tjob)


@pytest.mark.parametrize("label_smoothing", [0.0, 0.1])
@pytest.mark.parametrize("query_types", ["sp_po", "s_o"])
def test_kvsall_subbatches_match_kge_tpu(synth, query_types, label_smoothing):
    """Batches of 32 in subbatches of 8: each subbatch keeps the label
    coordinates of its own rows (``__row_offset__``)."""
    opts = all_options("KvsAll", **QUERY_TYPES[query_types], **{
        "KvsAll.label_smoothing": label_smoothing, "train.batch_size": 32,
        "train.subbatch_size": 8})
    jjob, tjob = make_job_pair(synth, SYNTH, opts)
    for want, got in run_batch_steps(jjob, tjob):
        np.testing.assert_allclose(got, want, rtol=1e-5)
    assert_same_state(jjob, tjob)


@pytest.mark.parametrize("train_type,batch_size", [("1vsAll", 6), ("KvsAll", 256),
                                                   ("KvsAll", 32)])
def test_subbatches_equal_the_whole_batch(synth, train_type, batch_size):
    """The port's subbatched step against its unsubbatched step on the same
    batches. At batch 256 the label coordinates' bucket is 256 entries too,
    and they stay whole: every subbatch keeps its own rows' labels."""
    where = (DATASET_DIR, "dataset_test") if train_type == "1vsAll" else (synth, SYNTH)
    extra = {"train.batch_size": batch_size}
    if train_type == "KvsAll":
        extra.update(QUERY_TYPES["sp_po"])
    jobs = [make_job_pair(*where, all_options(train_type, **extra,
                                              **{"train.subbatch_size": sub}))[1]
            for sub in (-1, batch_size // 4)]
    batches = list(jobs[0]._batches())
    if batch_size == 256:
        assert any(len(b["label_rows"]) == 256 for b in batches)
    for batch in batches[:3]:
        variant = jobs[0]._step_variant(batch)
        arrays = {k: torch.tensor(v) for k, v in batch.items()
                  if k != "true_size" and not isinstance(v, str)}
        costs = [float(job._train_step(dict(arrays), job._current_lrs(), variant)[0])
                 for job in jobs]
        np.testing.assert_allclose(costs[1], costs[0], rtol=1e-5)
    for a, b in zip(torch_tables(jobs[0]), torch_tables(jobs[1])):
        np.testing.assert_allclose(a, b, atol=5e-6, rtol=0)


def test_indivisible_subbatch_size_is_refused_as_by_kge_tpu():
    options = train_options(**{"train.subbatch_size": 4})
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", options)
    batch = next(iter(jjob._batches()))
    arrays = {"triples": batch["triples"].astype(np.int64), "mask": batch["mask"]}
    arrays.update(shared_negatives(np.random.default_rng(0), arrays["triples"],
                                   (0, 2), 4, [7, 3, 7]))
    with pytest.raises(ValueError) as jerror:
        jjob._raw_step(jjob.model_params, jjob.opt_state,
                       {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                        for k, v in arrays.items()},
                       jax.random.PRNGKey(0), jjob._current_lrs())
    with pytest.raises(ValueError) as terror:
        tjob._train_step({k: torch.tensor(v) for k, v in arrays.items()},
                         tjob._current_lrs())
    assert str(terror.value) == str(jerror.value)
    assert "must be divisible by train.subbatch_size=4" in str(terror.value)


def test_subbatched_epochs_match_kge_tpu():
    """Whole epochs with host-drawn negatives: the same losses and trace
    keys (kge_tpu's subbatched aux has no per-slot losses)."""
    options = train_options(**ACC, **{"negative_sampling.on_device": "never",
                                      "train.subbatch_size": 3})
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", options)
    for epoch in (1, 2):
        jjob.epoch = tjob.epoch = epoch
        jentry, tentry = jjob.run_epoch(), tjob.run_epoch()
        np.testing.assert_allclose(tentry["avg_loss"], jentry["avg_loss"], rtol=1e-4)
        assert set(jentry) - set(tentry) <= {"scanned"}
        assert set(tentry) - set(jentry) == set()
    assert_same_state(jjob, tjob)


# -- out of memory ----------------------------------------------------------------


def _oom_job(auto_tune, batch_size=6, subbatch_size=-1):
    options = train_options(**ACC, **{"train.subbatch_auto_tune": auto_tune,
                                      "train.batch_size": batch_size,
                                      "train.subbatch_size": subbatch_size})
    _, job = make_job_pair(DATASET_DIR, "dataset_test", options)
    messages = []
    real_log = job.config.log
    job.config.log = lambda msg, *a, **k: (messages.append(msg), real_log(msg, *a, **k))
    return job, messages


def _arrays(job, seed=0):
    batch = next(iter(job._batches()))
    arrays = {"triples": batch["triples"].astype(np.int64), "mask": batch["mask"]}
    arrays.update(shared_negatives(np.random.default_rng(seed), arrays["triples"],
                                   (0, 2), 4, [7, 3, 7]))
    return {k: torch.tensor(v) for k, v in arrays.items()}


def _raise_once(fn, error):
    state = {"raised": False}

    def wrapped(*args, **kwargs):
        if not state["raised"]:
            state["raised"] = True
            raise error
        return fn(*args, **kwargs)

    return wrapped


def _oom():
    return torch.cuda.OutOfMemoryError("CUDA out of memory. Tried to allocate 2.00 GiB")


@pytest.mark.parametrize("batch_size,subbatch_size,halved", [
    (6, -1, 3), (6, 3, 1), (10, 5, 2), (8, -1, 4)])
def test_oom_before_the_first_write_halves_and_retries(batch_size, subbatch_size,
                                                       halved):
    """With auto-tuning, an out-of-memory error raised before the optimizer
    wrote anything halves the subbatch size (down to a divisor of the batch
    size), logs it and retries: the step is the step at the new size."""
    job, messages = _oom_job(True, batch_size, subbatch_size)
    _, reference = make_job_pair(DATASET_DIR, "dataset_test", train_options(**ACC, **{
        "train.batch_size": batch_size, "train.subbatch_size": halved}))
    arrays = _arrays(job)
    job._loss_for_batch = _raise_once(job._loss_for_batch, _oom())
    cost, aux = job._step_with_retries(dict(arrays), job._current_lrs(), None)
    assert job._subbatch_size == halved
    assert job.config.get("train.subbatch_size") == halved
    assert any(f"halving subbatch size to {halved} and retrying" in m for m in messages)
    want, _ = reference._train_step(dict(arrays), reference._current_lrs())
    np.testing.assert_allclose(float(cost), float(want), rtol=1e-6)
    for a, b in zip(torch_tables(job), torch_tables(reference)):
        np.testing.assert_allclose(a, b, atol=1e-6, rtol=0)
    assert int(job.opt_state["step"]) == 1


def test_oom_without_auto_tune_propagates():
    job, messages = _oom_job(False)
    start = [t.copy() for t in torch_tables(job)]
    job._loss_for_batch = _raise_once(job._loss_for_batch, _oom())
    with pytest.raises(torch.cuda.OutOfMemoryError):
        job._step_with_retries(_arrays(job), job._current_lrs(), None)
    assert job._subbatch_size == -1 and job.config.get("train.subbatch_size") == -1
    assert not any("subbatch" in m for m in messages)
    for a, b in zip(torch_tables(job), start):
        assert np.array_equal(a, b)


@pytest.mark.parametrize("auto_tune", [True, False])
def test_oom_after_the_first_write_propagates(auto_tune):
    """An error raised once the optimizer began to write in place is not
    retried; with auto-tuning the halved size is set for a resume, with
    kge_tpu's message."""
    job, messages = _oom_job(auto_tune)
    job.optimizer.update = _raise_once(job.optimizer.update, _oom())
    with pytest.raises(torch.cuda.OutOfMemoryError):
        job._step_with_retries(_arrays(job), job._current_lrs(), None)
    assert job._subbatch_size == -1
    assert job.config.get("train.subbatch_size") == (3 if auto_tune else -1)
    resume_note = [m for m in messages if "cannot retry in-process" in m]
    assert len(resume_note) == (1 if auto_tune else 0)


def test_other_errors_are_not_caught():
    job, messages = _oom_job(True)
    job._loss_for_batch = _raise_once(job._loss_for_batch,
                                      RuntimeError("CUDA error: an illegal memory access"))
    with pytest.raises(RuntimeError, match="illegal memory access"):
        job._step_with_retries(_arrays(job), job._current_lrs(), None)
    assert job._subbatch_size == -1
    assert not any("subbatch" in m for m in messages)
