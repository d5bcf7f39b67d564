"""The scanned epoch (``train.epoch_scan``) and edge partitioning
(``parallel.partition_edges``) of kge_tpu_torch against kge_tpu on the CPU.

- ``_epoch_scan_enabled`` decides as kge_tpu's does, with its message;
- 1vsAll ComplEx: the port's scanned epoch, handed kge_tpu's permutation
  (the same ``jax.random`` calls on the key kge_tpu used), equals kge_tpu's
  scanned epoch, per-batch costs and tables;
- KvsAll: two scanned epochs (batches grouped by query type) equal
  kge_tpu's two scanned epochs, trace entries key for key;
- negative sampling: the scanned epoch equals the unscanned one in every
  bit on every route, since both take the job's numpy permutation;
- ``run_epoch_group(3)`` equals three ``run_epoch`` calls;
- the partitioned layout equals the batches that kge_tpu's partitioned
  epoch trains on (recorded under ``jax.disable_jit()`` around its raw
  step), for sizes that the data axis and ``bs / D`` divide and do not;
- one two-rank gloo run of a partitioned 1vsAll epoch over 2 x 1, each
  rank's host copy of the other shard's rows poisoned, against kge_tpu's
  partitioned trajectory over two CPU devices with the same shard
  permutations.

Tolerances as in the training tests: losses rtol 1e-5, tables atol 5e-6.
"""

import pickle

import jax
import numpy as np
import pytest
import torch

import kge_tpu
import kge_tpu_torch
from kge_tpu.ops import pallas_ops
from kge_tpu_torch.job.train import partition_layout
from kge_tpu_torch.ops import embedding_ops
from tests.test_torch_train_1vsall_kvsall import QUERY_TYPES
from tests.test_torch_train_1vsall_kvsall import options as all_options
from tests.torch_parity import (
    assert_same_state,
    make_config,
    make_job_pair,
    pooled_options,
    torch_tables,
    train_options,
)
from tests.util import DATASET_DIR, make_synthetic_dataset

SYNTH = "scan_synth"


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    pallas_ops.set_gather_mode("xla")
    embedding_ops.set_gather_mode("torch")


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(tmp_path_factory.mktemp("scan") / SYNTH,
                                  num_entities=64, num_relations=8, num_train=512,
                                  seed=13)


def _torch_job(folder, dataset_name, options):
    from kge_tpu_torch.job import TrainingJob

    config = make_config(kge_tpu_torch, dataset_name, options)
    dataset = kge_tpu_torch.Dataset.create(config, folder=str(folder))
    job = TrainingJob.create(config, dataset)
    job._prepare()
    job._is_prepared = True
    return job


def _record_fetched(job):
    """Each scanned epoch's fetched per-batch scalars, as the job finalizes
    it (both packages' ``_finalize_epoch_scanned``)."""
    fetched = []
    finalize = job._finalize_epoch_scanned

    def wrapped(got, meta):
        fetched.append(got)
        return finalize(got, meta)

    job._finalize_epoch_scanned = wrapped
    return fetched


# -- the rule ------------------------------------------------------------------------


@pytest.mark.parametrize("mode", ["auto", "always", "never"])
@pytest.mark.parametrize("blocker", [None, "trace_batch", "pre_batch", "post_batch",
                                     "forward_only"])
def test_epoch_scan_rule_as_kge_tpu(mode, blocker):
    """``auto`` scans unless batch tracing or a batch hook needs the host at
    every batch, ``always`` raises kge_tpu's message then, ``never`` and a
    forward-only job do not scan."""
    from kge_tpu.job import TrainingJob as JaxTrainingJob
    from kge_tpu_torch.job import TrainingJob as TorchTrainingJob

    options = train_options(**{"train.epoch_scan": mode})
    if blocker == "trace_batch":
        options["train.trace_level"] = "batch"
    outcome = {}
    for package, create in ((kge_tpu, JaxTrainingJob.create),
                            (kge_tpu_torch, TorchTrainingJob.create)):
        config = make_config(package, "dataset_test", options)
        dataset = package.Dataset.create(config, folder=str(DATASET_DIR))
        job = create(config, dataset, forward_only=blocker == "forward_only")
        if blocker in ("pre_batch", "post_batch"):
            getattr(job, f"{blocker}_hooks").append(lambda job: None)
        try:
            outcome[package.__name__] = job._epoch_scan_enabled()
        except ValueError as e:
            outcome[package.__name__] = str(e)
    assert outcome["kge_tpu_torch"] == outcome["kge_tpu"]
    blocked = blocker in ("trace_batch", "pre_batch", "post_batch")
    if mode == "always" and blocked:
        assert outcome["kge_tpu"] == ("train.epoch_scan=always conflicts with "
                                      "batch-level tracing or batch hooks")
    else:
        assert outcome["kge_tpu"] is (
            mode != "never" and blocker != "forward_only" and not blocked)


# -- against kge_tpu's scanned epochs ---------------------------------------------------


def _kge_permutation(jjob, size):
    """The permutation of kge_tpu's next scanned epoch: its epoch key split
    from the job's root key, then the permutation key split from that
    (kge_tpu/job/train.py:725-727)."""
    key, _ = jax.random.split(jjob._root_key)
    perm_key, _ = jax.random.split(key)
    return np.asarray(jax.random.permutation(perm_key, size))


@pytest.mark.parametrize("batch_size", [5, 6])
def test_1vsall_scanned_epoch_equals_kge_tpu(batch_size):
    """ComplEx on dataset_test: two scanned epochs of both packages, the
    port's handed kge_tpu's permutation of each (batch 5 pads the last
    batch: kge_tpu's with its dummy row, the port's with the batch's last
    row, masked out either way; batch 6 does not pad)."""
    opts = all_options("1vsAll", **{"train.batch_size": batch_size})
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", opts)
    jfetched, tfetched = _record_fetched(jjob), _record_fetched(tjob)
    perms = []
    tjob._draw_scan_permutation = lambda size: perms[-1]
    for epoch in (1, 2):
        perms.append(_kge_permutation(jjob, jjob.num_examples))
        jjob.epoch = tjob.epoch = epoch
        jentry, tentry = jjob.run_epoch(), tjob.run_epoch()
        assert jentry["scanned"] is tentry["scanned"] is True
        assert set(jentry) == set(tentry)
        for key in ("batches", "size", "num_parameters", "avg_penalties"):
            assert tentry[key] == jentry[key], key
        np.testing.assert_allclose(tentry["avg_loss"], jentry["avg_loss"], rtol=1e-5)
        # per-batch costs and losses
        for i in (0, 1):
            np.testing.assert_allclose(tfetched[-1][i], np.asarray(jfetched[-1][i]),
                                       rtol=1e-5)
    assert_same_state(jjob, tjob)


@pytest.mark.parametrize("query_types", ["sp_po", "all"])
def test_kvsall_scanned_epochs_equal_kge_tpu(synth, query_types):
    """Two scanned KvsAll epochs (batches grouped by query type, one pass a
    type) of both packages from the same weights, batch 32 on the
    synthetic graph; kge_tpu builds the batches from the same numpy
    generator, so the epochs are equal whole."""
    opts = all_options("KvsAll", **QUERY_TYPES[query_types],
                       **{"train.batch_size": 32})
    jjob, tjob = make_job_pair(synth, SYNTH, opts)
    jfetched, tfetched = _record_fetched(jjob), _record_fetched(tjob)
    for epoch in (1, 2):
        jjob.epoch = tjob.epoch = epoch
        jentry, tentry = jjob.run_epoch(), tjob.run_epoch()
        assert set(jentry) == set(tentry) and tentry["scanned"] is True
        for key in ("batches", "size", "type", "scope", "split", "event",
                    "num_parameters", "avg_penalties", "epoch"):
            assert tentry[key] == jentry[key], key
        np.testing.assert_allclose(tentry["avg_loss"], jentry["avg_loss"], rtol=1e-5)
        np.testing.assert_allclose(tfetched[-1][0], np.asarray(jfetched[-1][0]),
                                   rtol=1e-5)
    assert tjob._scan_caps == jjob._scan_caps
    assert_same_state(jjob, tjob)


# -- against the port's own unscanned epoch -------------------------------------------------

ACC = {"train.optimizer.default.args.initial_accumulator_value": 0.1}
ROUTES = {
    "shared": train_options(**ACC),
    "shared-penalty": train_options(**ACC, **{"lookup_embedder.regularize_weight": 0.01}),
    "batch": train_options(**ACC, **{"negative_sampling.shared": False,
                                     "negative_sampling.implementation": "batch"}),
    "all": train_options(**ACC, **{"negative_sampling.shared": False,
                                   "negative_sampling.implementation": "all"}),
    "triple-transe": pooled_options("transe", **ACC, **{
        "negative_sampling.implementation": "triple"}),
    "pool-rotate": pooled_options("rotate"),
    "sparse": train_options(**ACC, **{"train.sparse_embedding_update": "always"}),
    "fused": train_options(**ACC, **{"negative_sampling.fused_scoring": "always"}),
    "subbatches": train_options(**ACC, **{"train.subbatch_size": 3}),
}


def _same_bits(a, b):
    return a.dtype == b.dtype and a.shape == b.shape and np.array_equal(
        a.view(np.uint8), b.view(np.uint8))


@pytest.mark.parametrize("route,batch_size", [
    (route, batch_size) for route in ROUTES for batch_size in (5, 6)
    if route != "subbatches" or batch_size == 6])
def test_negative_sampling_scanned_epoch_equals_unscanned_in_bits(route, batch_size):
    """Two epochs with ``epoch_scan`` auto (scanned) and never (batch by
    batch) from the same seed: the same batches and negatives, so every
    table and optimizer state is equal in every bit (batch 5 pads the last
    batch, with its last row in both)."""
    jobs = [_torch_job(DATASET_DIR, "dataset_test",
                       {**ROUTES[route], "train.batch_size": batch_size,
                        "train.epoch_scan": scan})
            for scan in ("auto", "never")]
    entries = []
    for job in jobs:
        got = []
        for epoch in (1, 2):
            job.epoch = epoch
            got.append(job.run_epoch())
        entries.append(got)
    assert [e.get("scanned") for e in entries[0]] == [True, True]
    assert [e.get("scanned") for e in entries[1]] == [None, None]
    for a, b in zip(*entries):
        assert (a["batches"], a["size"]) == (b["batches"], b["size"])
        np.testing.assert_allclose(a["avg_loss"], b["avg_loss"], rtol=1e-6)
    for a, b in zip(torch_tables(jobs[0]), torch_tables(jobs[1])):
        assert _same_bits(a, b)
    for a, b in zip(jobs[0].opt_state["leaves"], jobs[1].opt_state["leaves"]):
        assert sorted(a) == sorted(b)
        for key in a:
            assert _same_bits(a[key].numpy(), b[key].numpy()), key


@pytest.mark.parametrize("train_type", ["negative_sampling", "KvsAll"])
def test_epoch_group_equals_epochs(synth, train_type):
    """``run_epoch_group(3)`` (one fetch for the group) against three
    ``run_epoch`` calls with the scheduler stepped between them, from the
    same seed: equal tables and losses; the group's entries carry its
    timing keys."""
    opts = (train_options(**ACC, **{"train.lr_scheduler": "StepLR",
                                    "train.lr_scheduler_args": {"step_size": 1,
                                                                "gamma": 0.5}})
            if train_type == "negative_sampling"
            else all_options("KvsAll", **QUERY_TYPES["sp_po"], **{"train.batch_size": 32}))
    where = (DATASET_DIR, "dataset_test") if train_type == "negative_sampling" \
        else (synth, SYNTH)
    group, single = (_torch_job(*where, opts) for _ in range(2))
    grouped = group.run_epoch_group(3)
    singles = []
    for _ in range(3):
        single.epoch += 1
        singles.append(single.run_epoch())
        single.kge_lr_scheduler.step()
    assert group.epoch == single.epoch == 3
    assert [e["epoch"] for e in grouped] == [1, 2, 3]
    for a, b in zip(grouped, singles):
        assert a["scanned"] is b["scanned"] is True
        assert (a["batches"], a["size"]) == (b["batches"], b["size"])
        assert a["avg_loss"] == b["avg_loss"]
        assert ("group_pipelined" in a) == (train_type == "KvsAll")
    for a, b in zip(torch_tables(group), torch_tables(single)):
        assert _same_bits(a, b)


# -- edge partitioning ------------------------------------------------------------------------


def _kge_partitioned_batches(folder, dataset_name, options, data, epochs):
    """kge_tpu's partitioned epochs over ``data`` CPU devices, recorded
    under ``jax.disable_jit()`` around its raw step: the job, per epoch the
    D shard permutations (from the key it used), every batch's triples and
    mask and the epoch's loss, and the job's initial weights."""
    from kge_tpu.job import TrainingJob as JaxTrainingJob

    config = make_config(kge_tpu, dataset_name, {
        **options, "parallel.data": data, "parallel.model": 1,
        "parallel.partition_edges": "always"})
    dataset = kge_tpu.Dataset.create(config, folder=str(folder))
    job = JaxTrainingJob.create(config, dataset)
    job._prepare()
    job._is_prepared = True
    assert job._partition_edges
    initial = jax.tree_util.tree_map(np.asarray, job.model_params)
    batches = []
    raw = job._raw_step

    def recording(params, opt_state, batch, rng, lr):
        batches.append((np.asarray(batch["triples"]), np.asarray(batch["mask"])))
        return raw(params, opt_state, batch, rng, lr)

    job._raw_step = recording
    layout = partition_layout(job.num_examples, data, job.batch_size)
    out = []
    with jax.disable_jit():
        for epoch in range(1, epochs + 1):
            key, _ = jax.random.split(job._root_key)
            perm_key, _ = jax.random.split(key)
            perms = np.asarray(jax.vmap(lambda k: jax.random.permutation(
                k, layout.slots))(jax.random.split(perm_key, data)))
            start = len(batches)
            job.epoch = epoch
            entry = job.run_epoch()
            out.append({"perms": perms, "batches": batches[start:],
                        "avg_loss": entry["avg_loss"]})
    return job, out, initial


class _Shard:
    """A stand-in for the mesh of data coordinate ``index`` of ``data``: its
    gathers record the rank's piece of each batch."""

    def __init__(self, data, index):
        self.data, self.data_index, self.model = data, index, 1
        self.active = True
        self.pieces = []

    def gather_data(self, piece):
        self.pieces.append(piece.clone())
        return torch.stack([piece] * self.data)


@pytest.mark.parametrize("num_train,data,batch_size", [
    (24, 2, 4),   # every shard and every bs / D divides
    (24, 2, 8),   # shards of 12 in slots of 16: padding in every shard
    (27, 4, 8),   # shards of 7, 7, 7, 6 in slots of 8
    (25, 3, 6),   # shards of 9, 9, 7 in slots of 10
])
def test_partition_layout_equals_kge_tpu(tmp_path, num_train, data, batch_size):
    """Every batch of kge_tpu's partitioned epoch against the port's: each
    simulated rank's piece (``_scanned_batches`` over its shard on its own
    card) for the same shard permutations, stacked in shard order; masks
    equal, triples equal on every unmasked row, and the padding slots at
    the shard's own last triple."""
    name = f"part_{num_train}"
    folder = make_synthetic_dataset(tmp_path / name, num_entities=10, num_relations=3,
                                    num_train=num_train, seed=num_train)
    options = all_options("1vsAll", **{"train.batch_size": batch_size})
    _, recorded, _ = _kge_partitioned_batches(folder, name, options, data, epochs=2)
    tjob = _torch_job(folder, name, options)
    layout = partition_layout(tjob.num_examples, data, batch_size)
    assert len(recorded[0]["batches"]) == layout.batches
    for epoch in recorded:
        pieces = []
        for shard in range(data):
            tjob.device_ctx = _Shard(data, shard)
            tjob._partition_edges = True
            tjob._device_epoch_triples = None
            tjob._ensure_epoch_scan(tjob._scan_data())
            assert tuple(tjob._device_epoch_triples.shape) == (layout.slots, 3)
            list(tjob._scanned_batches(epoch["perms"]))
            pieces.append(tjob.device_ctx.pieces)
        for b, (triples, mask) in enumerate(epoch["batches"]):
            got = torch.cat([pieces[s][b] for s in range(data)]).numpy()
            np.testing.assert_array_equal(got[:, 3], mask.astype(np.int64))
            real = mask > 0
            np.testing.assert_array_equal(got[real, :3], triples[real])
            for s in range(data):
                n_s, base = int(layout.sizes[s]), layout.base
                piece = pieces[s][b].numpy()
                padded = piece[:, 3] == 0
                want = tjob.triples[s * base + n_s - 1]
                assert (piece[padded, :3] == want).all()
        assert sum(int(m.sum()) for _, m in epoch["batches"]) == num_train


def test_partitioned_1vsall_over_two_ranks_equals_kge_tpu(tmp_path):
    """A partitioned 1vsAll epoch over 2 x 1 gloo ranks, each rank's host
    copy of the other shard's rows poisoned (tests/test_multiprocess.py's
    check), against kge_tpu's partitioned epochs over two CPU devices,
    handed its shard permutations: the epochs' losses, per-batch costs and
    entity tables; each rank's card holds its shard alone."""
    from tests.torch_mesh import launch

    name = "part_ranks"
    folder = make_synthetic_dataset(tmp_path / name, num_entities=16, num_relations=4,
                                    num_train=45, seed=5)
    options = all_options("1vsAll", **{"train.batch_size": 8})
    jjob, recorded, initial = _kge_partitioned_batches(folder, name, options, 2,
                                                        epochs=2)
    arrays = tmp_path / "arrays.pkl"
    with open(arrays, "wb") as f:
        pickle.dump({"params": initial, "perms": [e["perms"] for e in recorded]}, f)
    results = launch({"tasks": [{
        "name": "partitioned", "kind": "partitioned", "data": str(folder),
        "arrays": str(arrays),
        "options": {**options, "dataset.name": name, "parallel.data": 2,
                    "parallel.model": 1, "parallel.partition_edges": "auto"},
    }]}, 2, tmp_path / "ranks")["partitioned"]
    layout = partition_layout(45, 2, 8)
    for rank, got in enumerate(results):
        assert got["partition_edges"] and got["scanned"] == [True, True]
        assert got["device_triples_shape"] == [layout.slots, 3]
        np.testing.assert_allclose(got["losses"], [e["avg_loss"] for e in recorded],
                                   rtol=1e-5)
        np.testing.assert_allclose(np.load(got["tables"])["entity"],
                                   np.asarray(jjob.model_params["entity_embedder"][
                                       "embeddings"]), atol=5e-6, rtol=0)
    assert results[0]["costs"] == results[1]["costs"]
