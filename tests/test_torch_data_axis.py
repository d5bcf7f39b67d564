"""Subbatches (``train.subbatch_size``) on the data axis of the port's mesh
(kge_tpu_torch/parallel), on the CPU over gloo.

Subbatch ``i`` is rows ``[i s, (i + 1) s)`` of the whole batch, as kge_tpu's
``reshape(n_sub, sub)`` of the batch-sharded array is; every rank draws what
the whole subbatch needs (negatives, dropout masks) in the order one process
draws it, and takes its rows. The rank processes (tests/torch_mesh.py) run
at dp2 (2 x 1) and dp2 x mp2 (2 x 2) on tests/util.py's synthetic graph,
ComplEx d = 16, batch 64 in subbatches of 16, Adagrad:

- KvsAll, 1vsAll, negative sampling with shared negatives drawn on the host
  and with per-row negatives drawn on the device under embedding dropout,
  and reciprocal ConvE KvsAll (its batch statistics over the data group):
  one step's loss and tables within rtol 1e-4, atol 1e-5 of one process's
  subbatched step, and, where no draw depends on the subbatch (KvsAll,
  1vsAll, host-drawn negatives), of one process's unsubbatched step; two
  epochs' losses within rtol 1e-4, atol 1e-5 of one process's, equal on
  every rank;
- ConvE in subbatches keeps its running statistics at 0 and 1 over the
  ranks too (kge_tpu keeps only ``avg_loss`` of a subbatch, ROADMAP C.4);
- a subbatch size that does not divide over the data axis is refused with
  kge_tpu's kind of message.

And the initial table of a model axis (1 x 2) over 140,000 entities, drawn
in blocks of 65,536 rows (models/base.py ``INIT_BLOCK_ROWS``): each rank's
rows equal one process's in every bit, under ``normal_`` and under a
normalized ``xavier_uniform_`` (scaled by the whole table's shape).

ConvE's convolution and projection biases have gradients that are zero up
to rounding (batch norm follows them): Adagrad's first step turns that
rounding into a step of about lr, differently in each run, so those two
leaves are left out of the table comparisons (as chip_smoke.py phase 20
treats them); the losses do not depend on them.
"""

import numpy as np
import pytest

from tests import torch_mesh
from tests.util import make_synthetic_dataset

MESHES = {"dp2": (2, 1), "dp2xmp2": (2, 2)}
SUB = 16

BASE = {
    "model": "complex",
    "dataset.name": "synth_par",
    "train.type": "negative_sampling",
    "train.batch_size": 64,
    "train.subbatch_size": SUB,
    "train.max_epochs": 2,
    "valid.every": 0,
    "complex.entity_embedder.dim": 16,
    "complex.relation_embedder.dim": 16,
    "train.optimizer.default.type": "Adagrad",
    "train.optimizer.default.args.lr": 0.1,
    "random_seed.default": 5,
}
DROPOUT = {"complex.entity_embedder.dropout": 0.2,
           "complex.relation_embedder.dropout": 0.1}
ROUTES = {
    "KvsAll": {"train.type": "KvsAll"},
    "1vsAll": {"train.type": "1vsAll"},
    "ns_host": {"negative_sampling.shared": True,
                "negative_sampling.on_device": "never"},
    "ns_device_dropout": {"negative_sampling.shared": False,
                          "negative_sampling.implementation": "batch", **DROPOUT},
    "conve_KvsAll": {"model": "reciprocal_relations_model",
                     "reciprocal_relations_model.base_model.type": "conve",
                     "conve.entity_embedder.dim": 32,
                     "conve.relation_embedder.dim": 32, "train.type": "KvsAll"},
}
#: the routes whose subbatched step draws nothing per subbatch, so that it
#: is one process's unsubbatched step up to the order of the sums
WHOLE = ("KvsAll", "1vsAll", "ns_host")
#: leaves whose gradient is zero up to rounding (see the module docstring)
ZERO_GRADIENT = ("scorer/conv_b", "scorer/proj_b")
STATS = ("bn1_mean", "bn1_var", "bn2_mean", "bn2_var")
CASES = [(name, route) for name in MESHES for route in ROUTES]


def options(mesh, route, **extra):
    data, model = mesh
    return {**BASE, "parallel.data": data, "parallel.model": model,
            **ROUTES[route], **extra}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return str(make_synthetic_dataset(tmp_path_factory.mktemp("data") / "synth_par"))


_RESULTS = {}
_ALONE = {}


@pytest.fixture
def data_run(synth, tmp_path_factory):
    """One launch of a mesh's ranks with every route's task (a step with
    its tables, then two epochs), and in this process each route's task at
    1 x 1 in subbatches and (WHOLE) its step without subbatches."""

    def run(name):
        if name in _RESULTS:
            return _RESULTS[name]
        mesh = MESHES[name]
        work = tmp_path_factory.mktemp(f"data_axis_{name}")
        tasks = [{"name": route, "kind": "steps", "data": synth, "steps": 1,
                  "epochs": 2, "tables": str(work / route),
                  "options": options(mesh, route)} for route in ROUTES]
        ranks = torch_mesh.launch({"tasks": tasks}, mesh[0] * mesh[1], work)
        alone = {}
        for task in tasks:
            route = task["name"]
            for kind, extra in (("sub", {}), ("whole", {"train.subbatch_size": 0})):
                if kind == "whole" and route not in WHOLE:
                    continue
                single = dict(task, tables=f"{task['tables']}-alone-{kind}",
                              options=options((1, 1), route, **extra))
                if kind == "whole":
                    single["epochs"] = 0
                key = (route, kind)
                if key not in _ALONE:
                    _ALONE[key] = torch_mesh.TASKS["steps"](
                        single, work / f"alone-{route}-{kind}")
                alone[key] = _ALONE[key]
        _RESULTS[name] = (ranks, alone)
        return _RESULTS[name]

    return run


def assert_tables_close(got_file, want_file, what):
    """Every leaf and optimizer state of a rank's tables (its entity rows
    from ``lo``) within rtol 1e-4, atol 1e-5 of one process's, but the
    ZERO_GRADIENT leaves."""
    got, want = np.load(got_file), np.load(want_file)
    lo = int(got["lo"])
    compared = 0
    for key in got.files:
        if key == "lo" or key.split(":")[0] in ZERO_GRADIENT:
            continue
        mine, theirs = got[key], want[key]
        if key.startswith("entity_embedder/embeddings"):
            theirs = theirs[lo:lo + len(mine)]
        np.testing.assert_allclose(mine, theirs, rtol=1e-4, atol=1e-5,
                                   err_msg=f"{what}: {key}")
        compared += 1
    assert compared >= 4, (what, got.files)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name,route", CASES)
def test_subbatched_step_matches_one_process(data_run, name, route):
    """One step from the initial weights over the ranks, in subbatches of
    the whole batch's rows: its loss and tables against one process's
    subbatched step and, where nothing is drawn per subbatch, its
    unsubbatched step."""
    ranks, alone = data_run(name)
    kinds = ("sub", "whole") if route in WHOLE else ("sub",)
    for rank, got in enumerate(ranks[route]):
        for kind in kinds:
            want = alone[(route, kind)]
            np.testing.assert_allclose(got["steps"], want["steps"], rtol=1e-4,
                                       atol=1e-5, err_msg=f"rank {rank} {kind}")
            assert_tables_close(got["tables"], want["tables"],
                                f"rank {rank} against {kind}")


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name,route", CASES)
def test_subbatched_epochs_match_one_process(data_run, name, route):
    ranks, alone = data_run(name)
    want = alone[(route, "sub")]["epochs"]
    for rank, got in enumerate(ranks[route]):
        assert len(got["epochs"]) == 2
        np.testing.assert_allclose(got["epochs"], want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"rank {rank}")
        assert got["epochs"] == ranks[route][0]["epochs"]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", list(MESHES))
def test_conve_statistics_stay_at_zero_and_one_in_subbatches(data_run, name):
    """kge_tpu's subbatched step keeps only ``avg_loss`` of each
    subbatch's aux, so ConvE's running statistics are never written: 0 and
    1 after the step, on every rank as in one process."""
    ranks, alone = data_run(name)
    runs = [r["tables"] for r in ranks["conve_KvsAll"]]
    runs.append(alone[("conve_KvsAll", "sub")]["tables"])
    for tables in runs:
        got = np.load(tables)
        for stat in STATS:
            value = 1.0 if stat.endswith("var") else 0.0
            assert np.all(got[f"scorer/{stat}"] == value), (tables, stat)


def test_subbatch_size_must_divide_over_the_data_axis(synth, tmp_path):
    """Each rank takes its rows of every subbatch, so the subbatch size
    divides over the data axis, as the batch size does."""
    from kge_tpu_torch.parallel.mesh import DeviceCtx

    job = torch_mesh.make_job(
        {"data": synth, "options": options((1, 1), "KvsAll",
                                           **{"train.subbatch_size": 8})},
        tmp_path / "job")
    job.device_ctx = DeviceCtx(data=4, model=1)
    job._check_shardable()
    job._subbatch_size = 6
    with pytest.raises(ValueError, match=r"train.subbatch_size=6 must be "
                                         r"divisible by the data mesh axis \(4\)"):
        job._check_shardable()


BIG_ENTITIES = 140_000
INIT_CASES = {
    "normal": {},
    "xavier_normalized": {"complex.entity_embedder.initialize": "xavier_uniform_",
                          "complex.entity_embedder.normalize.p": 2.0},
}


@pytest.mark.timeout(600)
def test_row_shards_are_one_process_s_rows_in_bits(tmp_path_factory):
    """Two blocks and a part of a third, the shards' boundary inside the
    second: every rank draws every block and keeps its rows."""
    from kge_tpu_torch.models.base import INIT_BLOCK_ROWS

    assert BIG_ENTITIES > 2 * INIT_BLOCK_ROWS
    work = tmp_path_factory.mktemp("init_rows")
    big = str(make_synthetic_dataset(work / "synth_big", num_entities=BIG_ENTITIES,
                                     num_relations=4, num_train=BIG_ENTITIES))
    tasks = [{"name": case, "kind": "init_rows", "data": big, "rows": str(work / case),
              "options": {**options((1, 2), "ns_host"), "dataset.name": "synth_big",
                          **extra}}
             for case, extra in INIT_CASES.items()]
    ranks = torch_mesh.launch({"tasks": tasks}, 2, work)
    for task in tasks:
        single = dict(task, rows=task["rows"] + "-alone",
                      options={**task["options"], "parallel.model": 1})
        whole = np.load(torch_mesh.TASKS["init_rows"](single, work / "alone")["rows"])
        whole = whole["rows"]
        assert whole.shape == (BIG_ENTITIES, 16)
        for rank, got in enumerate(ranks[task["name"]]):
            shard = np.load(got["rows"])
            lo, rows = int(shard["lo"]), shard["rows"]
            assert (lo, len(rows)) == (rank * BIG_ENTITIES // 2, BIG_ENTITIES // 2)
            assert rows.tobytes() == whole[lo:lo + len(rows)].tobytes(), (
                task["name"], rank)
