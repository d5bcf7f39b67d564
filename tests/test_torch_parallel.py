"""The port's (data, model) mesh over ranks (kge_tpu_torch/parallel), on the
CPU over gloo, against the port in one process and against kge_tpu on its
virtual CPU mesh.

The invariant is kge_tpu's (tests/test_parallel.py): an N-rank run
computes the single-process run. The rank processes (tests/torch_mesh.py,
brought up by ``KGE_COORDINATOR_ADDRESS`` / ``KGE_NUM_PROCESSES`` /
``KGE_PROCESS_ID``) run at dp2 (2 x 1), mp2 (1 x 2) and dp2 x mp2 (2 x 2)
on tests/util.py's synthetic graph, ComplEx d = 16, batch 64:

- negative sampling on the dense step and on the row-sparse step (Adagrad
  through K3's plain version, Adam through K4's), with dropout and per-row
  negatives, and (data axis) 1vsAll and KvsAll: two epochs' losses within
  rtol 1e-4, atol 1e-5 of one process's;
- at 1 x 2 and 2 x 2, kge_tpu's initial weights, batches and injected
  negatives through the raw train step, against kge_tpu's steps on its
  mesh of the same shape (losses within rtol 1e-4), and the filtered
  metrics of kge_tpu's final weights equal to kge_tpu's and to one
  process's, metric for metric;
- lockstep: every rank's initial entity rows and the whole first batch's
  negatives equal one process's, and a rank's dropout masks are its rows
  of one process's;
- the 2 x 2 run's sharded checkpoint loads in kge_tpu's
  ``load_checkpoint`` unchanged, its tables the ranks' rows;
- K1 over column shards (the plain versions of ``rank_pivots`` and of the
  tile launch with a given pivot) equal to K1 whole, bit for bit;
- ``distributed.fetch`` and the mesh's ``gather_data`` give every piece;
- the backend rule, and a rank that raises ends its peers.
"""

import math
import pickle

import numpy as np
import pytest
import torch

from tests import torch_mesh
from tests.util import make_synthetic_dataset

MESHES = {"dp2": (2, 1), "mp2": (1, 2), "dp2xmp2": (2, 2)}

BASE = {
    "model": "complex",
    "dataset.name": "synth_par",
    "train.type": "negative_sampling",
    "train.batch_size": 64,
    "train.max_epochs": 2,
    "valid.every": 0,
    "complex.entity_embedder.dim": 16,
    "complex.relation_embedder.dim": 16,
    "train.optimizer.default.type": "Adagrad",
    "train.optimizer.default.args.lr": 0.1,
    "negative_sampling.shared": True,
    "random_seed.default": 5,
}

ROUTES = {
    "dense": {},
    "sparse_adagrad": {"train.sparse_embedding_update": "always"},
    "sparse_adam": {"train.sparse_embedding_update": "always",
                    "train.optimizer.default.type": "Adam",
                    "train.optimizer.default.args.lr": 0.01},
    "dropout_per_row": {"complex.entity_embedder.dropout": 0.2,
                        "complex.relation_embedder.dropout": 0.1,
                        "negative_sampling.shared": False,
                        "negative_sampling.implementation": "batch"},
    "1vsAll": {"train.type": "1vsAll"},
    "KvsAll": {"train.type": "KvsAll"},
}
#: the routes each mesh runs here (the model axis's full-vocabulary routes:
#: tests/test_torch_mesh_routes.py)
MESH_ROUTES = {
    "dp2": list(ROUTES),
    "mp2": ["dense", "sparse_adagrad", "sparse_adam", "dropout_per_row"],
    "dp2xmp2": ["dense", "sparse_adagrad", "sparse_adam", "dropout_per_row"],
}
PARITY_STEPS = 6


def options(mesh, **extra):
    data, model = mesh
    return {**BASE, "parallel.data": data, "parallel.model": model, **extra}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return str(make_synthetic_dataset(tmp_path_factory.mktemp("data") / "synth_par"))


def run_alone(task, folder):
    """A task of tests/torch_mesh.py in this process, at 1 x 1."""
    return torch_mesh.TASKS[task["kind"]](task, folder)


def kge_tpu_arrays(synth, mesh, path):
    """kge_tpu on its virtual mesh of ``mesh``'s shape: its initial
    weights, PARITY_STEPS batches with injected shared negatives through its
    raw step, its losses and final weights, and the filtered metrics of the
    final weights; the arrays pickled to ``path`` for the ranks."""
    import jax
    import jax.numpy as jnp

    import kge_tpu
    from kge_tpu.job import EvaluationJob, TrainingJob
    from tests.torch_parity import make_config, shared_negatives

    config = make_config(kge_tpu, "synth_par", options(mesh))
    config.folder = str(path) + "-kge_tpu"
    config.init_folder()
    dataset = kge_tpu.Dataset.create(config, folder=synth)
    job = TrainingJob.create(config, dataset)
    job._prepare()
    job._is_prepared = True
    assert job.device_ctx.active
    params = jax.tree_util.tree_map(np.asarray, job.model_params)
    rng = np.random.default_rng(7)
    slots = job._active_slots
    vocab = [int(v) for v in job._sampler.vocabulary_size]
    num = int(job._sampler.num_samples[slots[0]])
    batches, losses = [], []
    for step, batch in zip(range(PARITY_STEPS), job._batches()):
        triples = batch["triples"].astype(np.int64)
        arrays = {"triples": triples, "mask": batch["mask"],
                  **shared_negatives(rng, triples, slots, num, vocab)}
        jbatch = {k: jnp.asarray(v.astype(np.int32) if v.dtype == np.int64 else v)
                  for k, v in arrays.items()}
        job.model_params, job.opt_state, _, aux = job._raw_step(
            job.model_params, job.opt_state, jbatch, jax.random.PRNGKey(step),
            job._current_lrs())
        losses.append(float(aux["avg_loss"]))
        batches.append(arrays)
    final = jax.tree_util.tree_map(np.asarray, job.model_params)
    eval_config = config.clone()
    eval_config.set("job.type", "eval")
    eval_config.set("eval.split", "valid")
    ev = EvaluationJob.create(eval_config, dataset, job, job.model)
    ev.model_params = job.model_params
    ev.epoch = 1
    metrics = {k: v for k, v in ev._evaluate().items()
               if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))}
    with open(path, "wb") as f:
        pickle.dump({"params": params, "batches": batches, "final_params": final}, f)
    return losses, metrics


_RESULTS = {}


@pytest.fixture
def mesh_run(synth, tmp_path_factory):
    """The results of one launch of the ranks of a mesh (every task of the
    mesh in one launch), and the same tasks in this process at 1 x 1."""

    def run(name):
        if name in _RESULTS:
            return _RESULTS[name]
        mesh = MESHES[name]
        work = tmp_path_factory.mktemp(f"mesh_{name}")
        tasks = [{"name": route, "kind": "epochs", "data": synth,
                  "options": options(mesh, **ROUTES[route])}
                 for route in MESH_ROUTES[name]]
        tasks.append({"name": "lockstep", "kind": "lockstep", "data": synth,
                      "options": options(mesh, **ROUTES["dropout_per_row"])})
        tasks.append({"name": "collectives", "kind": "collectives",
                      "options": options(mesh)})
        kge = None
        if mesh[1] > 1:
            arrays = work / "kge_tpu.pckl"
            kge = kge_tpu_arrays(synth, mesh, arrays)
            tasks.append({"name": "parity", "kind": "parity", "data": synth,
                          "arrays": str(arrays), "options": options(mesh)})
        if mesh == (2, 2):
            tasks.append({"name": "save", "kind": "epochs", "data": synth,
                          "epochs": 1, "save": str(work / "sharded.pt"),
                          "options": options(mesh)})
        ranks = torch_mesh.launch({"tasks": tasks}, mesh[0] * mesh[1], work)
        alone = {}
        for task in tasks:
            if task["kind"] == "collectives" or "save" in task:
                continue
            single = dict(task, options={**task["options"], "parallel.data": 1,
                                         "parallel.model": 1})
            alone[task["name"]] = run_alone(single, work / f"alone-{task['name']}")
        _RESULTS[name] = (ranks, alone, kge, work)
        return _RESULTS[name]

    return run


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name,route", [
    (name, route) for name in MESHES for route in MESH_ROUTES[name]])
def test_mesh_losses_match_one_process(mesh_run, name, route):
    ranks, alone, _, _ = mesh_run(name)
    want = alone[route]["losses"]
    for rank, got in enumerate(ranks[route]):
        assert len(got["losses"]) == 2
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"rank {rank}")
        assert got["losses"] == ranks[route][0]["losses"]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", ["mp2", "dp2xmp2"])
def test_mesh_matches_kge_tpu_mesh(mesh_run, name):
    """kge_tpu's weights, batches and negatives: losses within rtol 1e-4 of
    kge_tpu's on its mesh, and the filtered metrics of kge_tpu's final
    weights equal to kge_tpu's and to one process's."""
    ranks, alone, (kge_losses, kge_metrics), _ = mesh_run(name)
    for rank, got in enumerate(ranks["parity"]):
        np.testing.assert_allclose(got["losses"], kge_losses, rtol=1e-4,
                                   err_msg=f"rank {rank}")
        assert got["metrics"] == kge_metrics, rank
    assert alone["parity"]["metrics"] == kge_metrics
    assert len(kge_metrics) > 10


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", list(MESHES))
def test_ranks_draw_in_lockstep(mesh_run, name):
    """Every rank's initial entity rows are one process's rows, and the
    negatives it draws for the whole first batch are one process's."""
    ranks, alone, _, _ = mesh_run(name)
    want = alone["lockstep"]
    table = np.asarray(want["rows"])
    for rank, got in enumerate(ranks["lockstep"]):
        rows = np.asarray(got["rows"])
        assert np.array_equal(rows, table[got["lo"]:got["lo"] + len(rows)]), rank
        assert got["negatives"] == want["negatives"], rank
    assert set(want["negatives"]) >= {"neg_samples_0", "neg_samples_2",
                                      "neg_distinct_0", "neg_position_2"}


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", list(MESHES))
def test_fetch_and_gather_data_give_every_piece(mesh_run, name):
    """``distributed.fetch`` gives every rank every rank's piece in rank
    order, bit for bit; ``DeviceCtx.gather_data`` the pieces of its data
    group (the ranks of its mesh column) in data-coordinate order."""
    ranks, _, _, _ = mesh_run(name)
    data, model = MESHES[name]
    world = data * model
    want = [[[r, -0.0], [0.5, -r]] for r in range(world)]
    for rank, got in enumerate(ranks["collectives"]):
        assert got["fetched"] == want, rank
        assert [math.copysign(1.0, x[0][1]) for x in got["fetched"]] == [-1.0] * world
        column = [10 * (d * model + rank % model) for d in range(data)]
        assert got["gathered"] == column, rank


@pytest.mark.timeout(600)
def test_sharded_checkpoint_loads_in_kge_tpu(mesh_run):
    """The 2 x 2 run's checkpoint: 4 shard files, and kge_tpu's
    ``load_checkpoint`` (unchanged) reassembles the entity table and its
    Adagrad sums from them; the table is the ranks' rows, and the port
    reads the same, whole or a range of rows."""
    from kge_tpu.utils.io import load_checkpoint as kge_tpu_load
    from kge_tpu_torch.utils.io import load_checkpoint

    ranks, _, _, work = mesh_run("dp2xmp2")
    path = work / "sharded.pt"
    assert all((work / f"sharded.pt.shard{r:05d}").exists() for r in range(4))
    theirs = kge_tpu_load(str(path))
    table = theirs["model"][0]["entity_embedder"]["embeddings"]
    assert isinstance(table, np.ndarray) and table.shape == (64, 16)
    for got in ranks["save"]:
        rows = np.asarray(got["rows"], dtype=np.float32)
        assert np.array_equal(table[got["lo"]:got["lo"] + len(rows)], rows)
    assert theirs["optimizer_state"]["leaves"][0]["sum"].shape == (64, 16)
    ours = load_checkpoint(str(path))
    assert np.array_equal(ours["model"][0]["entity_embedder"]["embeddings"], table)
    assert theirs["epoch"] == ours["epoch"] == 1
    # a rank of a model axis reads its rows alone (any range of rows)
    for lo, hi in ((0, 32), (32, 64), (10, 50)):
        rows = load_checkpoint(str(path), rows=(lo, hi))
        assert np.array_equal(rows["model"][0]["entity_embedder"]["embeddings"],
                              table[lo:hi])
        assert np.array_equal(rows["optimizer_state"]["leaves"][0]["sum"],
                              theirs["optimizer_state"]["leaves"][0]["sum"][lo:hi])


def test_dropout_masks_are_the_rows_of_one_process():
    """Under ``dropout_rows`` a rank's dropout masks are its rows of the
    mask one process draws for the whole batch, for tensors of the batch's
    rows (and multiples of them), and whole for ``whole`` lookups."""
    from kge_tpu_torch.models.base import KgeBase

    module = KgeBase.__new__(KgeBase)
    torch.nn.Module.__init__(module)
    module.dropout = 0.3
    module.train()
    x = torch.randn(8 * 3, 5)

    def masks(offset=None):
        module.dropout_generator = torch.Generator().manual_seed(11)
        module.dropout_rows = None if offset is None else (offset, 2, 8)
        if offset is None:
            return module._dropout(x), module._dropout(x[:7], whole=True)
        rows = module._dropout(x[3 * offset:3 * (offset + 2)])
        return rows, module._dropout(x[:7], whole=True)

    whole, shared = masks()
    for offset in (0, 2, 6):
        rows, shared_rank = masks(offset)
        assert torch.equal(rows, whole[3 * offset:3 * (offset + 2)])
        assert torch.equal(shared_rank, shared)
    module.dropout_rows = (0, 2, 8)
    with pytest.raises(ValueError, match="rows are not"):
        module._dropout(x[:5])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("epilogue", [False, True], ids=["plain", "l2"])
@pytest.mark.parametrize("shards", [2, 4])
def test_rank_kernel_over_column_shards(dtype, epilogue, shards):
    """The plain versions of ``rank_pivots`` and of the tile launch with a
    given pivot, summed over the column shards, equal the unsharded plain
    counts, pivots and label values bit for bit (NaN, -inf and +inf
    pivots among the rows)."""
    from kge_tpu_torch.ops.rank_kernel import (
        NEG_SQRT_L2,
        csr_row_ids,
        fused_rank_counts,
        rank_pivots,
    )

    rng = np.random.default_rng(3)
    dtype = getattr(torch, dtype)
    E, n, D = 96, 12, 24
    targets = torch.tensor(rng.normal(0, 0.3, (E, D)), dtype=dtype)
    q = torch.tensor(rng.normal(0, 0.3, (n, D)), dtype=dtype)
    true = torch.tensor(rng.integers(0, E, n), dtype=torch.int32)
    q[2] = float("nan")
    q[5] = 0.0
    q[5, 0] = -float("inf") * torch.sign(targets[true[5], 0])
    per_row = [np.union1d(rng.choice(E, k, replace=False), [int(true[i])])
               for i, k in enumerate(rng.integers(0, 9, n))]
    cols = torch.tensor(np.concatenate(per_row), dtype=torch.int32)
    row_ptr = torch.tensor(np.concatenate([[0], np.cumsum([len(r) for r in per_row])]),
                           dtype=torch.int32)
    score_map = NEG_SQRT_L2 if epilogue else None
    g, c, vals, pivot = fused_rank_counts(q, targets, None, row_ptr, cols, E,
                                          1e-5, 1e-4, score_map=score_map,
                                          pivot_cols=true)
    per = E // shards
    summed = torch.full((n,), -0.0)
    for m in range(shards):
        summed += rank_pivots(q, targets[m * per:(m + 1) * per], true, m * per,
                              score_map=score_map).float()
    shard_pivot = summed.to(dtype)
    rows = csr_row_ids(row_ptr)
    g_sum, c_sum = torch.zeros_like(g), torch.zeros_like(c)
    vals_sum = torch.zeros_like(vals)
    for m in range(shards):
        keep = (cols >= m * per) & (cols < (m + 1) * per)
        ptr = torch.zeros_like(row_ptr)
        ptr[1:] = torch.cumsum(torch.bincount(rows[keep], minlength=n), 0)
        gm, cm, vm, pm = fused_rank_counts(
            q, targets[m * per:(m + 1) * per], shard_pivot, ptr,
            cols[keep] - m * per, per, 1e-5, 1e-4, score_map=score_map)
        g_sum += gm
        c_sum += cm
        vals_sum[keep] = vm

    def bits(x):
        view = torch.int16 if x.dtype == torch.bfloat16 else torch.int32
        return torch.where(torch.isnan(x), torch.zeros_like(x.view(view)), x.view(view))

    assert torch.equal(bits(shard_pivot), bits(pivot))
    assert torch.equal(torch.isnan(shard_pivot), torch.isnan(pivot))
    assert torch.equal(g_sum, g) and torch.equal(c_sum, c)
    assert torch.equal(bits(vals_sum), bits(vals))


def test_backend_rule():
    """gloo on the CPU and wherever two ranks share a card (NCCL refuses
    that), nccl between distinct cards, on one host or several."""
    from kge_tpu_torch.parallel.distributed import choose_backend

    assert choose_backend("cpu", [("h", "cpu"), ("h", "cpu")]) == "gloo"
    assert choose_backend("cuda", [("h", "GPU-a"), ("h", "GPU-b")]) == "nccl"
    assert choose_backend("cuda", [("h", "GPU-a"), ("g", "GPU-b")]) == "nccl"
    assert choose_backend("cuda", [("h", "GPU-a"), ("h", "GPU-a")]) == "gloo"
    assert choose_backend("cuda", [("h", "GPU-a"), ("h", "GPU-b"),
                                   ("h", "GPU-a")]) == "gloo"


@pytest.mark.timeout(300)
def test_a_rank_that_raises_ends_its_peers(synth, tmp_path):
    """Rank 1 raises before its first collective; rank 0 waits in it until
    the timeout (10 s here) and raises too: both exit non-zero, and
    neither hangs."""
    spec = {"tasks": [{"name": "dense", "kind": "epochs", "data": synth,
                       "raises": 1, "options": options((2, 1))}]}
    codes, outs = torch_mesh.launch(spec, 2, tmp_path, timeout=120,
                                    env_extra={"KGE_DISTRIBUTED_TIMEOUT": "10"},
                                    check=False)
    assert codes[0] != 0 and codes[1] != 0, outs
    assert "rank 1 raises as the test asks" in outs[1]
