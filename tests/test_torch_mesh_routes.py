"""The model axis of the port's mesh (kge_tpu_torch/parallel) on the
full-vocabulary routes, on the CPU over gloo: 1vsAll, KvsAll, negative
sampling's ``all``, ``pool`` and ``fused_scoring: always``, and kge_tpu's
ring schedule (kge_tpu_torch/parallel/ring.py).

The rank processes (tests/torch_mesh.py; one launch for each mesh shape,
with every task of that shape) run at mp2 (1 x 2) and dp2 x mp2 (2 x 2), and
reciprocal ConvE KvsAll at dp2 (2 x 1) too, on tests/util.py's synthetic
graph, ComplEx d = 16, batch 64:

- each route's two epochs' losses within rtol 1e-4, atol 1e-5 of one
  process's, equal on every rank; ``pool`` is TransE-L1 d = 16 scored
  through the pooled kernel's plain version (``pooled_kernel: always``),
  with Adagrad, and with plain SGD besides (``pool_sgd``), and P-rotate's
  route in small (RotatE-L1 d = 16 pools, Adam's row-sparse step); at
  dp2 x mp2 ``pool``'s two epochs start from one process's checkpoint of
  epoch 1 (``POOL_DATA_AXIS``), and its first step from the initial
  weights differs from one process's only where Adagrad's first step
  meets a gradient that rounds to zero;
- ComplEx 1vsAll with embedding dropout (the unfused schedule, the whole
  vocabulary's dropout mask) and with a projection embedder (a projection
  that every rank holds alike, met by its own entity rows), and reciprocal
  ConvE KvsAll with dropout at every mesh (a scorer's parameters across the
  column shards; its batch statistics over the data group); after one
  step over a data axis ConvE's running statistics are equal in every bit
  on every rank and within 1e-6 of one process's (of their largest);
- no rank ever holds more than its |E| / M columns of a batch's scores:
  the widest 2-D tensor of the rank's batch rows that any operation of the
  epochs returns, backward passes included, has |E| / M columns on the
  full-vocabulary routes (|E| in one process) and no more on the others;
- 1vsAll, KvsAll, KvsAll in subbatches of 16 and ConvE KvsAll (dropout
  off: kge_tpu draws its own masks) with kge_tpu's initial weights and
  batches through the raw train step, against kge_tpu's steps on its
  virtual mesh of the same shape (losses within rtol 1e-4), the
  counterpart of
  tests/test_parallel.py's ``test_sharded_matches_single_device`` and
  ``test_kvsall_sharded``;
- at 2 x 2, the counterpart of tests/test_parallel.py's
  ``test_ring_scoring_engages_and_matches``: the ring engages under
  ``parallel.ring_scoring: auto`` and not under ``never``, its columns of
  ids 0..7 equal the unfused schedule's in every bit, the gradients of one
  batch's loss agree within 1e-6, and one epoch's losses within rtol 1e-6;
- every loss over the column shards of a model group against the loss of
  the whole rows, in float64: the rows' terms and the gradient on each
  rank's columns.
"""

import pickle

import numpy as np
import pytest

from tests import torch_mesh
from tests.util import make_synthetic_dataset

MESHES = {"dp2": (2, 1), "mp2": (1, 2), "dp2xmp2": (2, 2)}
NUM_ENTITIES = 64  # tests/util.py's synthetic graph

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
    "random_seed.default": 5,
}

CONVE = {"model": "reciprocal_relations_model",
         "reciprocal_relations_model.base_model.type": "conve",
         "conve.entity_embedder.dim": 32, "conve.relation_embedder.dim": 32,
         "train.type": "KvsAll"}
CONVE_NO_DROPOUT = {"conve.entity_embedder.dropout": 0.0,
                    "conve.relation_embedder.dropout": 0.0,
                    "conve.feature_map_dropout": 0.0, "conve.projection_dropout": 0.0}
STATS = ("bn1_mean", "bn1_var", "bn2_mean", "bn2_var")
POOL = {"model": "transe", "transe.l_norm": 1.0,
        "transe.entity_embedder.dim": 16, "transe.relation_embedder.dim": 16,
        "negative_sampling.shared": False,
        "negative_sampling.implementation": "pool",
        "negative_sampling.pooled_kernel": "always"}
ROUTES = {
    "1vsAll": {"train.type": "1vsAll"},
    # the unfused schedule (the ring does not engage with dropout): the
    # whole vocabulary's dropout mask, each rank keeping its rows
    "1vsAll_dropout": {"train.type": "1vsAll", "complex.entity_embedder.dropout": 0.2,
                       "complex.relation_embedder.dropout": 0.1},
    "KvsAll": {"train.type": "KvsAll"},
    "all": {"negative_sampling.shared": False,
            "negative_sampling.implementation": "all"},
    # the projection's gradient from the rank's own rows is their share
    "1vsAll_projection": {"train.type": "1vsAll",
                          "complex.entity_embedder.type": "projection_embedder",
                          "complex.entity_embedder.base_embedder.dim": 16,
                          "complex.entity_embedder.base_embedder.space": "complex",
                          "complex.entity_embedder.regularize_args.weighted": False},
    "pool": POOL,
    "pool_sgd": {**POOL, "train.optimizer.default.type": "sgd"},
    "fused": {"negative_sampling.shared": True,
              "negative_sampling.fused_scoring": "always"},
    # P-rotate's route in small: RotatE-L1 pools through the pooled
    # kernels' plain versions, Adam's row-sparse step through the fused
    # row update's
    "pool_rotate_sparse": {
        "model": "rotate", "rotate.entity_embedder.dim": 16,
        "negative_sampling.shared": False,
        "negative_sampling.implementation": "pool",
        "negative_sampling.pooled_kernel": "always",
        "train.loss": "bce_self_adversarial",
        "train.sparse_embedding_update": "always",
        "train.optimizer.default.type": "Adam",
        "train.optimizer.default.args.lr": 0.01},
    # a scorer with parameters and batch-norm statistics: ConvE's parameters
    # pass ``ModelCopy`` on the unfused schedule, its statistics are the
    # whole batch's over the data group (``DataSum``)
    "conve_KvsAll": CONVE,
    # the same without dropout, for kge_tpu's mesh (it draws its own masks)
    "conve_KvsAll_nodrop": {**CONVE, **CONVE_NO_DROPOUT},
    # subbatches of the whole batch's rows, for kge_tpu's mesh: the label
    # coordinates of a rank's rows of each subbatch
    "KvsAll_sub16": {"train.type": "KvsAll", "train.subbatch_size": 16},
}
#: the routes that only kge_tpu's mesh runs (tests/test_torch_data_axis.py
#: holds subbatches against one process)
PARITY_ONLY = ("conve_KvsAll_nodrop", "KvsAll_sub16")
#: the routes each mesh runs; the data axis alone runs ConvE's
MESH_ROUTES = {"dp2": ["conve_KvsAll"],
               "mp2": [route for route in ROUTES if route not in PARITY_ONLY],
               "dp2xmp2": [route for route in ROUTES if route not in PARITY_ONLY]}
#: the routes that score every batch row against the whole vocabulary
FULL_VOCABULARY = ("1vsAll", "1vsAll_dropout", "1vsAll_projection", "KvsAll", "all")
#: ``pool`` with Adagrad under a data axis: its two epochs start from one
#: process's checkpoint of epoch 1, where every entry's Adagrad sum has
#: grown. From the initial weights they drift just beyond rtol 1e-4:
#: TransE-L1's gradients are sums of signed terms, the data ranks
#: add their partial sums in another order than one process, and Adagrad's
#: first step lr g / (|g| + eps) turns the rounding of a g that cancels to
#: about 0 into a step of up to lr. ``test_pool_adagrad_first_step`` shows
#: that this is the whole difference; ``pool_sgd`` holds the two epochs
#: from the initial weights.
POOL_DATA_AXIS = ("dp2xmp2", "pool")
#: a step's table entries beyond this of one process's are Adagrad's first
#: steps at a gradient that rounds to zero: at most the rounding that a sum
#: of the batch's 64 float32 terms leaves, 64 x 2^-24 of the largest
STEP_ATOL = 1e-6
ZERO_GRADIENT = 64 * 2.0 ** -24
PARITY_ROUTES = ("1vsAll", "KvsAll", "conve_KvsAll_nodrop", "KvsAll_sub16")
#: ConvE's running statistics over a data axis against one process's
STATS_RTOL = 1e-6
PARITY_STEPS = 6
LOSSES = ["bce", "bce_mean", "bce_self_adversarial", "kl", "soft_margin", "se",
          "margin_ranking"]
LOSS_CASES = [f"{name}/{kind}" for name in LOSSES
              for kind in (("index",) if name == "margin_ranking"
                           else ("index", "matrix"))]


def options(mesh, route):
    data, model = mesh
    return {**BASE, "parallel.data": data, "parallel.model": model, **ROUTES[route]}


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return str(make_synthetic_dataset(tmp_path_factory.mktemp("data") / "synth_par"))


def kge_tpu_batches(synth, mesh, route, path):
    """kge_tpu on its virtual mesh of ``mesh``'s shape: its initial weights
    and first PARITY_STEPS batches (with their step variants) through its
    raw steps, compiled; the arrays pickled to ``path`` for the ranks; its
    losses."""
    import jax
    import jax.numpy as jnp

    import kge_tpu
    from kge_tpu.job import TrainingJob
    from tests.torch_parity import make_config

    config = make_config(kge_tpu, "synth_par", options(mesh, route))
    config.folder = str(path) + "-kge_tpu"
    config.init_folder()
    dataset = kge_tpu.Dataset.create(config, folder=synth)
    job = TrainingJob.create(config, dataset)
    job._prepare()
    job._is_prepared = True
    assert job.device_ctx.active
    params = jax.tree_util.tree_map(np.asarray, job.model_params)
    batches, variants, losses, steps = [], [], [], {}
    for step, batch in zip(range(PARITY_STEPS), job._batches()):
        variant = job._step_variant(batch)
        arrays = {k: v for k, v in batch.items()
                  if k != "true_size" and not isinstance(v, str)}
        if variant not in steps:
            # compiled: op by op, each step's ring (shard_map) takes seconds
            steps[variant] = jax.jit(
                job._raw_step if variant is None else job._raw_steps[variant])
        raw = steps[variant]
        job.model_params, job.opt_state, _, aux = raw(
            job.model_params, job.opt_state,
            {k: jnp.asarray(v) for k, v in arrays.items()},
            jax.random.PRNGKey(step), job._current_lrs())
        losses.append(float(aux["avg_loss"]))
        batches.append(arrays)
        variants.append(variant)
    with open(path, "wb") as f:
        pickle.dump({"params": params, "batches": batches, "variants": variants}, f)
    return losses


_RESULTS = {}
_ALONE = {}


@pytest.fixture
def mesh_run(synth, tmp_path_factory):
    """The results of one launch of the ranks of a mesh (every task of the
    mesh in one launch), each route's epochs in this process at 1 x 1, and
    kge_tpu's parity losses."""

    def run(name):
        if name in _RESULTS:
            return _RESULTS[name]
        mesh = MESHES[name]
        work = tmp_path_factory.mktemp(f"mesh_routes_{name}")
        tasks = [{"name": route, "kind": "epochs", "data": synth, "widths": True,
                  "options": options(mesh, route)} for route in MESH_ROUTES[name]]
        for task in tasks:
            if (name, task["name"]) == POOL_DATA_AXIS:
                task["checkpoint"] = str(work / "pool-epoch1.pt")
                torch_mesh.TASKS["epochs"](
                    {"name": "pool", "kind": "epochs", "data": synth, "epochs": 1,
                     "save": task["checkpoint"], "options": options((1, 1), "pool")},
                    work / "pool-epoch1")
        kge = {}
        for route in PARITY_ROUTES:
            arrays = work / f"kge_tpu-{route}.pckl"
            kge[route] = kge_tpu_batches(synth, mesh, route, arrays)
            tasks.append({"name": f"parity-{route}", "kind": "parity", "data": synth,
                          "arrays": str(arrays), "options": options(mesh, route)})
        if mesh[0] > 1:
            tasks.append({"name": "conve_step", "kind": "steps", "data": synth,
                          "steps": 1, "tables": str(work / "conve_step"),
                          "options": options(mesh, "conve_KvsAll")})
        if mesh == (2, 2):
            tasks.append({"name": "ring", "kind": "ring", "data": synth,
                          "options": options(mesh, "1vsAll")})
            tasks.append({"name": "pool_step", "kind": "steps", "data": synth,
                          "steps": 1, "tables": str(work / "pool_step"),
                          "options": options(mesh, "pool")})
            tasks.append({"name": "losses", "kind": "losses", "losses": LOSSES,
                          "options": options(mesh, "1vsAll")})
        ranks = torch_mesh.launch({"tasks": tasks}, mesh[0] * mesh[1], work)
        alone = {}
        for task in tasks[:len(MESH_ROUTES[name])] + [t for t in tasks
                                                      if t["kind"] == "steps"]:
            single = dict(task, options={**task["options"], "parallel.data": 1,
                                         "parallel.model": 1})
            if "tables" in task:
                single["tables"] = task["tables"] + "-alone"
            key = repr(sorted(single.items()))
            if key not in _ALONE:
                _ALONE[key] = torch_mesh.TASKS[task["kind"]](
                    single, work / f"alone-{task['name']}")
            alone[task["name"]] = _ALONE[key]
        _RESULTS[name] = (ranks, alone, kge)
        return _RESULTS[name]

    return run


CASES = [(name, route) for name in MESHES for route in MESH_ROUTES[name]]
#: ConvE's feature maps are wider than a rank's columns at this size
WIDTH_CASES = [case for case in CASES if case[1] != "conve_KvsAll"]


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name,route", CASES)
def test_route_losses_match_one_process(mesh_run, name, route):
    ranks, alone, _ = mesh_run(name)
    want = alone[route]["losses"]
    for rank, got in enumerate(ranks[route]):
        assert len(got["losses"]) == 2
        np.testing.assert_allclose(got["losses"], want, rtol=1e-4, atol=1e-5,
                                   err_msg=f"rank {rank}")
        assert got["losses"] == ranks[route][0]["losses"]


def first_step_differences(tables, want):
    """Per leaf of a rank's ``tables`` after one Adagrad step against one
    process's (``want``; the steps task's arrays): the entries beyond
    STEP_ATOL, the largest difference there and elsewhere, and both runs'
    largest |g| there (the square root of the Adagrad sum g^2 after the
    first step) against their largest anywhere."""
    lo, out = int(tables["lo"]), {}
    for leaf in ("entity_embedder/embeddings", "relation_embedder/embeddings"):
        rows = slice(lo, lo + len(tables[leaf])) if "entity" in leaf else slice(None)
        diff = np.abs(tables[leaf] - want[leaf][rows])
        ours = np.sqrt(tables[f"{leaf}:sum"])
        theirs = np.sqrt(want[f"{leaf}:sum"][rows])
        beyond = diff > STEP_ATOL
        out[leaf] = {
            "beyond": int(beyond.sum()), "entries": int(diff.size),
            "max_diff_beyond": float(diff[beyond].max(initial=0.0)),
            "max_diff_elsewhere": float(diff[~beyond].max(initial=0.0)),
            "max_g_beyond": float(ours[beyond].max(initial=0.0)),
            "max_g": float(ours.max()),
            "max_g_beyond_alone": float(theirs[beyond].max(initial=0.0)),
            "max_g_alone": float(theirs.max())}
    return out


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", ["dp2", "dp2xmp2"])
def test_conve_statistics_are_the_whole_batch_statistics(mesh_run, name):
    """ConvE's batch-norm running statistics after one step over a data
    axis (dropout on): the whole batch's, summed over the data group, so
    equal in every bit on every rank and within STATS_RTOL of one process's
    (relative to each leaf's largest magnitude: a mean near 0 is a sum of
    terms that cancel); the step's loss within rtol 1e-6."""
    ranks, alone, _ = mesh_run(name)
    want = np.load(alone["conve_step"]["tables"])
    got = [np.load(r["tables"]) for r in ranks["conve_step"]]
    for rank, tables in enumerate(got):
        np.testing.assert_allclose(ranks["conve_step"][rank]["steps"],
                                   alone["conve_step"]["steps"], rtol=1e-6)
        for stat in STATS:
            leaf = f"scorer/{stat}"
            assert tables[leaf].tobytes() == got[0][leaf].tobytes(), (rank, leaf)
            scale = np.abs(want[leaf]).max()
            np.testing.assert_allclose(tables[leaf], want[leaf], rtol=STATS_RTOL,
                                       atol=STATS_RTOL * scale,
                                       err_msg=f"rank {rank} {leaf}")
            # the step moved them from 0 and 1
            assert np.abs(tables[leaf] - (stat.endswith("var"))).max() > 1e-3


@pytest.mark.timeout(600)
def test_pool_adagrad_first_step(mesh_run):
    """``pool`` with Adagrad over 2 x 2 ranks, one step from the initial
    weights: the step's loss within rtol 1e-6 of one process's, and every
    entry of the rank's entity rows and of the relation table within
    STEP_ATOL of one process's, but where both gradients round to zero
    (each within ZERO_GRADIENT of its largest), where the step may differ
    by up to lr. Prints the differences (``-s``)."""
    ranks, alone, _ = mesh_run("dp2xmp2")
    want = np.load(alone["pool_step"]["tables"])
    lr = BASE["train.optimizer.default.args.lr"]
    for rank, got in enumerate(ranks["pool_step"]):
        np.testing.assert_allclose(got["steps"], alone["pool_step"]["steps"],
                                   rtol=1e-6, err_msg=f"rank {rank}")
        diffs = first_step_differences(np.load(got["tables"]), want)
        print(f"rank {rank}: {diffs}")
        for leaf, d in diffs.items():
            assert d["max_g_beyond"] <= ZERO_GRADIENT * d["max_g"], (rank, leaf, d)
            assert d["max_g_beyond_alone"] <= ZERO_GRADIENT * d["max_g_alone"], (
                rank, leaf, d)
            assert d["max_diff_beyond"] <= lr, (rank, leaf, d)


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name,route", WIDTH_CASES)
def test_no_rank_holds_the_whole_score_matrix(mesh_run, name, route):
    """The widest tensor of a rank's batch rows: |E| / M columns where the
    route scores against the whole vocabulary (|E| in one process), never
    more elsewhere; the ring engaged on the ComplEx routes that score the
    whole vocabulary through ``score_sp``/``score_po``."""
    ranks, alone, _ = mesh_run(name)
    data, model = MESHES[name]
    per_rank = NUM_ENTITIES // model
    for rank, got in enumerate(ranks[route]):
        assert got["rows"] == 64 // data, rank
        if route in FULL_VOCABULARY:
            assert got["widest"] == per_rank, (rank, got["widest"])
        else:
            assert got["widest"] <= per_rank, (rank, got["widest"])
        assert (got["ring_calls"] > 0) == (route in ("1vsAll", "KvsAll")), got
    if route in FULL_VOCABULARY:
        assert alone[route]["widest"] == NUM_ENTITIES
    assert alone[route]["ring_calls"] == 0


@pytest.mark.timeout(600)
@pytest.mark.parametrize("name", list(MESHES))
@pytest.mark.parametrize("route", PARITY_ROUTES)
def test_full_vocabulary_routes_match_kge_tpu_mesh(mesh_run, name, route):
    """kge_tpu's initial weights and batches through both packages' raw
    steps on meshes of one shape: losses within rtol 1e-4."""
    ranks, _, kge = mesh_run(name)
    for rank, got in enumerate(ranks[f"parity-{route}"]):
        assert len(got["losses"]) == PARITY_STEPS
        np.testing.assert_allclose(got["losses"], kge[route], rtol=1e-4,
                                   err_msg=f"rank {rank}")


@pytest.mark.timeout(600)
def test_ring_engages_where_kge_tpu_engages_it(mesh_run):
    """``parallel.ring_scoring: auto`` engages the ring on the model axis
    (one call for each of a 1vsAll step's two directions), ``never`` does
    not."""
    ranks, _, _ = mesh_run("dp2xmp2")
    for rank, got in enumerate(ranks["ring"]):
        assert got["auto_engages"] and not got["never_engages"], rank
        assert got["auto_step_ring_calls"] == 2, rank
        assert got["never_step_ring_calls"] == 0, rank


@pytest.mark.timeout(600)
def test_ring_scores_equal_the_unfused_schedule_in_every_bit(mesh_run):
    """Ids 0..7 with relation 0: each rank's columns from the ring equal
    those of the unfused schedule bit for bit, in both directions."""
    ranks, _, _ = mesh_run("dp2xmp2")
    for rank, got in enumerate(ranks["ring"]):
        assert got["shape"] == [8, NUM_ENTITIES // 2], rank
        assert got["bits_equal"] and got["po_bits_equal"], rank


@pytest.mark.timeout(600)
def test_ring_gradients_match_the_unfused_schedule(mesh_run):
    """The written-out backward of the ring: the entity shard's and the
    relation table's gradients of the first batch's loss within 1e-6 of
    the unfused schedule's autograd."""
    ranks, _, _ = mesh_run("dp2xmp2")
    for rank, got in enumerate(ranks["ring"]):
        assert set(got["grad_max_abs_diff"]) == {"entity_embedder/embeddings",
                                                 "relation_embedder/embeddings"}
        for path, diff in got["grad_max_abs_diff"].items():
            assert diff <= 1e-6, (rank, path, diff)
            assert got["grad_max_abs"][path] > 1e-3, (rank, path)


@pytest.mark.timeout(600)
def test_ring_epoch_losses_match_the_unfused_schedule(mesh_run):
    ranks, _, _ = mesh_run("dp2xmp2")
    for rank, got in enumerate(ranks["ring"]):
        np.testing.assert_allclose(got["auto_loss"], got["never_loss"], rtol=1e-6,
                                   err_msg=f"rank {rank}")


@pytest.mark.timeout(600)
@pytest.mark.parametrize("case", LOSS_CASES)
def test_loss_over_column_shards_is_the_whole_rows_loss(mesh_run, case):
    """Each rank's rows' terms (in float64) within 1e-12 of the whole
    rows', relative to their size, and its gradient on its columns within
    1e-12 of the whole rows' gradient there: index labels (1vsAll), and a
    label matrix smoothed as KvsAll smooths it, with a row without a
    positive."""
    ranks, _, _ = mesh_run("dp2xmp2")
    for rank, got in enumerate(ranks["losses"]):
        diff = got[case]
        assert diff["rows"] <= 1e-12 * max(diff["scale"], 1.0), (rank, diff)
        assert diff["grad"] <= 1e-12, (rank, diff)
