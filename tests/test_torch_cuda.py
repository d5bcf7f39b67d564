"""Tests of kge_tpu_torch that need a CUDA card. They skip where there is
none; on the card they run without jax (this file imports only the port):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from kge_tpu_torch.ops import embedding_ops, rank_kernel
from kge_tpu_torch.ops.embedding_ops import (
    embedding_gather,
    rows_set,
    scatter_add_presorted,
    sorted_scatter_add,
    sorted_scatter_add_plain,
)
from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

ATOL, RTOL = 1e-5, 1e-4


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _inputs(seed, n, E, D):
    rng = np.random.default_rng(seed)
    q = rng.normal(0, 0.2, (n, D)).astype(np.float32)
    if n > 5:
        q[2] = np.nan
        q[5] = 0.0
        q[5, 0] = np.inf
    T = rng.normal(0, 0.2, (E, D)).astype(np.float32)
    per_row = [np.sort(rng.choice(E, size=int(rng.integers(0, 40)), replace=False))
               for _ in range(n)]
    row_ptr = np.concatenate([[0], np.cumsum([len(c) for c in per_row])])
    cols = np.concatenate(per_row)
    true = rng.integers(0, E, n)
    return [torch.tensor(a, dtype=dt) for a, dt in (
        (q, torch.float32), (T, torch.float32), (row_ptr, torch.int32),
        (cols, torch.int32), (true, torch.int32),
    )]


@pytest.mark.cuda
@pytest.mark.parametrize("n,E,D,num_valid", [(40, 1000, 64, 997), (33, 777, 30, 700),
                                             (2200, 3000, 64, 2990),
                                             (1, 50, 100, 50), (257, 100, 64, 90),
                                             (70, 3000, 100, 3000)])
def test_kernel_matches_plain_on_card(n, E, D, num_valid):
    """Counts equal the plain version's; the pivot is the kernel's own score
    at the true column, bit for bit the value it reports for that label."""
    device = _card()
    q, T, row_ptr, cols, true = (x.to(device) for x in _inputs(11, n, E, D))
    before = fused_rank_counts.launches
    g, c, vals, pivot = fused_rank_counts(q, T, None, row_ptr, cols, num_valid,
                                          ATOL, RTOL, pivot_cols=true)
    torch.cuda.synchronize()
    assert fused_rank_counts.launches == before + 1
    pg, pc, pvals, _ = rank_kernel.fused_rank_counts_plain(
        q, T, pivot, row_ptr, cols, num_valid, ATOL, RTOL
    )
    np.testing.assert_allclose(vals.cpu().numpy(), pvals.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(g, pg) and torch.equal(c, pc)
    # the true column ties with itself wherever its score is finite
    finite = torch.isfinite(pivot) & (true < num_valid)
    assert bool((c[finite] >= 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("n,E,D,num_valid,labels", [
    (257, 3000, 64, 2990, True), (2200, 1500, 30, 1500, True),
    (64, 100, 100, 77, False), (300, 14541, 512, 14541, True),
])
def test_kernel_outputs_do_not_depend_on_the_plan(n, E, D, num_valid, labels):
    """greater, close, vals and pivot are bit-equal across two launches and
    across column splits (the planned one, one range, five ranges, one wave
    of blocks); a label at the pivot column carries the pivot's bits; rows
    without labels and no labels at all are served."""
    device = _card()
    q, T, row_ptr, cols, true = (x.to(device) for x in _inputs(13, n, E, D))
    true = true % num_valid
    if not labels:
        row_ptr, cols = torch.zeros_like(row_ptr), cols[:0]
    sms = torch.cuda.get_device_properties(device).multi_processor_count

    def run(plan=None):
        out = fused_rank_counts(q, T, None, row_ptr, cols, num_valid, ATOL, RTOL,
                                pivot_cols=true, plan=plan)
        torch.cuda.synchronize()
        return [x.view(torch.int32) for x in out]

    first = run()
    plans = [None, rank_kernel.rank_plan(n, num_valid, num_ranges=1),
             rank_kernel.rank_plan(n, num_valid, num_ranges=5),
             rank_kernel.rank_plan(n, num_valid, num_ranges=2 * sms)]
    for plan in plans:
        assert all(torch.equal(a, b) for a, b in zip(first, run(plan))), plan
    at_pivot = cols == true[rank_kernel.csr_row_ids(row_ptr)]
    rows = rank_kernel.csr_row_ids(row_ptr)[at_pivot]
    assert torch.equal(first[2][at_pivot], first[3][rows])
    with pytest.raises(ValueError):  # a plan for another number of columns
        fused_rank_counts(q, T, None, row_ptr, cols, num_valid, ATOL, RTOL,
                          pivot_cols=true,
                          plan=rank_kernel.rank_plan(n, num_valid + 200))


@pytest.mark.cuda
def test_wrapper_raises_instead_of_falling_back():
    device = _card()
    q, T, row_ptr, cols, true = (x.to(device) for x in _inputs(3, 8, 50, 16))
    with pytest.raises(TypeError):
        fused_rank_counts(q.double(), T.double(), None, row_ptr, cols, 50,
                          ATOL, RTOL, pivot_cols=true)
    with pytest.raises(ValueError):  # not contiguous
        fused_rank_counts(q, T.t().contiguous().t(), None, row_ptr, cols, 50,
                          ATOL, RTOL, pivot_cols=true)
    with pytest.raises(ValueError):  # on another device
        fused_rank_counts(q, T.cpu(), None, row_ptr, cols, 50, ATOL, RTOL,
                          pivot_cols=true)
    with pytest.raises(TypeError):  # a given pivot of another dtype
        fused_rank_counts(q, T, torch.zeros(8, device=device, dtype=torch.float64),
                          row_ptr, cols, 50, ATOL, RTOL)
    with pytest.raises(NotImplementedError):  # an epilogue without a name
        fused_rank_counts(q, T, None, row_ptr, cols, 50, ATOL, RTOL,
                          score_map=torch.sqrt, pivot_cols=true)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16, torch.float16])
@pytest.mark.parametrize("epilogue", [False, True], ids=["plain", "l2"])
@pytest.mark.parametrize("shards", [2, 4, 8])
def test_rank_kernel_over_column_shards_on_card(dtype, epilogue, shards):
    """``rank_pivots`` of every column shard summed (in float32: one term
    is the pivot, the others -0.0) is the whole launch's pivot, and the tile
    launch of every shard against it sums to the whole launch's counts and
    gives its label values, bit for bit (NaN and +inf pivots among the
    rows)."""
    device = _card()
    n, E, D = 70, 2400, 64
    q, T, row_ptr, cols, true = (x.to(device) for x in _inputs(5, n, E, D))
    q, T = q.to(dtype), T.to(dtype)
    score_map = rank_kernel.NEG_SQRT_L2 if epilogue else None
    g, c, vals, pivot = fused_rank_counts(q, T, None, row_ptr, cols, E, ATOL, RTOL,
                                          score_map=score_map, pivot_cols=true)
    per = E // shards
    summed = torch.full((n,), -0.0, device=device)
    before = rank_kernel.rank_pivots.launches
    for m in range(shards):
        summed += rank_kernel.rank_pivots(q, T[m * per:(m + 1) * per].contiguous(),
                                          true, m * per, score_map=score_map).float()
    assert rank_kernel.rank_pivots.launches == before + shards
    shard_pivot = summed.to(dtype)
    rows = rank_kernel.csr_row_ids(row_ptr)
    g_sum, c_sum, vals_sum = torch.zeros_like(g), torch.zeros_like(c), torch.zeros_like(vals)
    sharded = fused_rank_counts.sharded_launches
    for m in range(shards):
        keep = (cols >= m * per) & (cols < (m + 1) * per)
        ptr = torch.zeros_like(row_ptr)
        ptr[1:] = torch.cumsum(torch.bincount(rows[keep], minlength=n), 0)
        gm, cm, vm, _ = fused_rank_counts(
            q, T[m * per:(m + 1) * per].contiguous(), shard_pivot, ptr,
            (cols[keep] - m * per).contiguous(), per, ATOL, RTOL, score_map=score_map)
        g_sum += gm
        c_sum += cm
        vals_sum[keep] = vm
    assert fused_rank_counts.sharded_launches == sharded + shards
    view = torch.int32 if dtype == torch.float32 else torch.int16

    def bits(x):
        return torch.where(torch.isnan(x), torch.zeros_like(x.view(view)), x.view(view))

    assert torch.equal(bits(shard_pivot), bits(pivot))
    assert torch.equal(g_sum, g) and torch.equal(c_sum, c)
    assert torch.equal(bits(vals_sum), bits(vals))


@pytest.mark.cuda
@pytest.mark.parametrize("n,E,d", [(40, 1000, 62), (257, 3000, 128), (33, 777, 30)])
def test_l2_epilogue_kernel_matches_plain_on_card(n, E, d):
    """The L2 score epilogue on the port's padded augmented operands: counts
    equal the plain version's, label values within rtol 1e-5; the epilogue
    maps the identity kernel's pivot and label values to the epilogue
    kernel's bit for bit (both round each operation correctly); the true
    column ties with itself, close pairs (where the expansion cancels)
    included."""
    from kge_tpu_torch.models.translation import _l2_factorization

    device = _card()
    rng = np.random.default_rng(n + E)
    q = rng.normal(0, 0.3, (n, d)).astype(np.float32)
    c = rng.normal(0, 0.3, (E, d)).astype(np.float32)
    true = rng.integers(0, E, n)
    c[true[:4]] = q[:4] + rng.normal(0, 1e-4, (4, d))  # near-zero distances
    q[5] = np.nan
    query, target_map, score_map = _l2_factorization(torch.tensor(q, device=device))
    targets = target_map(torch.tensor(c, device=device))
    assert query.shape[1] % 4 == 0 and score_map.code == 1
    _, _, row_ptr, cols, _ = (x.to(device) for x in _inputs(7, n, E, d))
    true = torch.tensor(true, dtype=torch.int32, device=device)
    before = fused_rank_counts.launches
    g, cl, vals, pivot = fused_rank_counts(query, targets, None, row_ptr, cols, E,
                                           ATOL, RTOL, score_map=score_map,
                                           pivot_cols=true)
    ig, ic, ivals, ipivot = fused_rank_counts(query, targets, None, row_ptr, cols,
                                              E, ATOL, RTOL, pivot_cols=true)
    torch.cuda.synchronize()
    assert fused_rank_counts.launches == before + 2
    assert torch.equal(score_map(ipivot).view(torch.int32), pivot.view(torch.int32))
    assert torch.equal(score_map(ivals).view(torch.int32), vals.view(torch.int32))
    pg, pc, pvals, _ = rank_kernel.fused_rank_counts_plain(
        query, targets, pivot, row_ptr, cols, E, ATOL, RTOL, score_map=score_map)
    np.testing.assert_allclose(vals.cpu().numpy(), pvals.cpu().numpy(),
                               rtol=1e-5, atol=1e-6)
    assert torch.equal(g, pg) and torch.equal(cl, pc)
    finite = torch.isfinite(pivot)
    assert bool((cl[finite] >= 1).all()) and not bool(finite[5])
    assert bool((pivot[:4] > -0.01).all())  # the close pairs


def _write_dataset(folder, seed, num_entities=300, num_relations=6,
                   sizes=(2000, 100, 100)):
    """A random graph in the .del layout (``dataset.yaml`` and the splits)."""
    rng = np.random.default_rng(seed)
    folder.mkdir(parents=True, exist_ok=True)
    total = sum(sizes)
    triples = np.stack([rng.integers(0, num_entities, total),
                        rng.integers(0, num_relations, total),
                        rng.integers(0, num_entities, total)], axis=1)
    start = 0
    for name, size in zip(("train", "valid", "test"), sizes):
        part = triples[start:start + size]
        start += size
        (folder / f"{name}.del").write_text(
            "".join("\t".join(map(str, t)) + "\n" for t in part.tolist()))
    for name, num in (("entity_ids", num_entities), ("relation_ids", num_relations)):
        (folder / f"{name}.del").write_text(
            "".join(f"{i}\t{name[0]}{i}\n" for i in range(num)))
    (folder / "dataset.yaml").write_text(
        f"dataset:\n  name: {folder.name}\n  num_entities: {num_entities}\n"
        f"  num_relations: {num_relations}\n")


@pytest.mark.cuda
@pytest.mark.parametrize("l_norm", [1.0, 2.0])
def test_transe_test_evaluation_on_card_equals_cpu(tmp_path, l_norm):
    """TransE's test evaluation on the card (L2: the rank kernel with its
    epilogue; L1: the score matrix, in chunks and whole) reports the CPU's
    metrics from the same weights."""
    from kge_tpu_torch import Config, Dataset
    from kge_tpu_torch.job import EvaluationJob
    from kge_tpu_torch.models import KgeModel, load_jax_params

    device = _card()
    data = tmp_path / "transe_synth"
    _write_dataset(data, 3)
    rng = np.random.default_rng(4)
    params = {"entity_embedder": {"embeddings": rng.normal(0, 0.3, (300, 32)).astype(np.float32)},
              "relation_embedder": {"embeddings": rng.normal(0, 0.3, (6, 32)).astype(np.float32)}}
    entries = {}
    for where, chunk in (("cuda", -1), ("cuda", 70), ("cpu", -1)):
        config = Config()
        config.load_options({"model": "transe"})
        for key, value in (("transe.l_norm", l_norm), ("lookup_embedder.dim", 32),
                           ("job.device", where), ("dataset.name", str(data)),
                           ("eval.split", "test"), ("eval.batch_size", 32),
                           ("entity_ranking.chunk_size", chunk),
                           ("console.quiet", True)):
            config.set(key, value)
        dataset = Dataset.create(config, folder=str(data))
        model = KgeModel.create(config, dataset, init_for_load_only=True)
        load_jax_params(model, params)
        job = EvaluationJob.create(config, dataset, model=model)
        job.epoch = 0
        before = fused_rank_counts.launches
        with torch.inference_mode():
            entries[where, chunk] = job._evaluate()
        launched = fused_rank_counts.launches - before
        # the rank kernel serves L2 on the card, twice a batch; L1 never
        assert launched == (2 * 4 if where == "cuda" and l_norm == 2.0 else 0)
    keys = [k for k in entries["cpu", -1]
            if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))]
    assert keys
    for key in keys:
        assert entries["cuda", -1][key] == entries["cpu", -1][key], key
        assert entries["cuda", 70][key] == entries["cpu", -1][key], key


FACTORIZATION_MODELS = {
    "distmult": {"model": "distmult", "lookup_embedder.dim": 16},
    "rescal": {"model": "rescal", "lookup_embedder.dim": 16},
    "cp": {"model": "cp", "lookup_embedder.dim": 16},
    "simple": {"model": "simple", "lookup_embedder.dim": 16},
    "relational_tucker3": {"model": "relational_tucker3",
                           "relational_tucker3.entity_embedder.dim": 16,
                           "relational_tucker3.relation_embedder.base_embedder.dim": 8},
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FACTORIZATION_MODELS))
def test_factorization_model_evaluation_on_card_equals_cpu(tmp_path, name):
    """DistMult, RESCAL, CP, SimplE and RelationalTucker3 rank through the
    rank kernel on the card (twice a batch) and report the CPU's metrics
    from the same weights."""
    from kge_tpu_torch import Config, Dataset
    from kge_tpu_torch.job import EvaluationJob
    from kge_tpu_torch.models import KgeModel, load_jax_params, to_jax_params

    _card()
    data = tmp_path / "factorization_synth"
    _write_dataset(data, 5)
    params, entries = None, {}
    for where in ("cpu", "cuda"):
        config = Config()
        config.load_options({"model": FACTORIZATION_MODELS[name]["model"]})
        for key, value in FACTORIZATION_MODELS[name].items():
            if key != "model":
                config.set(key, value, create=True)
        for key, value in (("lookup_embedder.initialize_args.std", 0.1),
                           ("job.device", where), ("dataset.name", str(data)),
                           ("eval.split", "test"), ("eval.batch_size", 32),
                           ("console.quiet", True)):
            config.set(key, value, create=True)
        dataset = Dataset.create(config, folder=str(data))
        model = KgeModel.create(config, dataset, init_for_load_only=True)
        if params is None:
            model.init_params(torch.Generator().manual_seed(6))
            params = to_jax_params(model)
        load_jax_params(model, params)
        job = EvaluationJob.create(config, dataset, model=model)
        job.epoch = 0
        before = fused_rank_counts.launches
        with torch.inference_mode():
            entries[where] = job._evaluate()
        assert fused_rank_counts.launches - before == (2 * 4 if where == "cuda" else 0)
    keys = [k for k in entries["cpu"]
            if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))]
    assert keys
    for key in keys:
        assert entries["cuda"][key] == entries["cpu"][key], key


# -- scatter kernel ---------------------------------------------------------------

SCATTER_CASES = {
    "uniform": lambda rng: (rng.integers(0, 3000, 5000), 3000, 64),
    "skewed": lambda rng: (np.where(rng.random(4000) < 0.8, 3,
                                    rng.integers(0, 50, 4000)), 50, 64),
    "one_row": lambda rng: (np.full(1000, 2), 5, 32),
    "arange": lambda rng: (np.arange(700), 900, 128),
    "empty": lambda rng: (np.zeros(0, dtype=np.int64), 40, 16),
    "single": lambda rng: (np.array([39]), 40, 16),
    "chunk_edges": lambda rng: (np.repeat([0, 2, 5], [32, 64, 33]), 7, 8),
    "d_not_multiple_of_4": lambda rng: (rng.integers(0, 20, 300), 20, 6),
    "d_eight": lambda rng: (rng.integers(0, 7, 12), 7, 8),
    # RESCAL's relation table at d = 16: rows of d^2 = 256
    "relation_d_squared": lambda rng: (rng.integers(0, 237, 512), 237, 256),
}


@pytest.mark.cuda
@pytest.mark.parametrize("case", sorted(SCATTER_CASES))
def test_scatter_kernel_matches_plain_on_card(case):
    """Against the plain version in float64: |error| <= 1e-6 + 1e-5 S, S the
    row's sum of |update| (float32 sums in another order); bit-equal across
    two launches; one launch counted per call."""
    device = _card()
    rng = np.random.default_rng(5)
    ids_np, num_rows, D = SCATTER_CASES[case](rng)
    ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
    upd = torch.tensor(rng.normal(size=(len(ids_np), D)).astype(np.float32),
                       device=device)
    before = sorted_scatter_add.launches
    got = sorted_scatter_add(ids, upd, num_rows)
    again = sorted_scatter_add(ids.int(), upd, num_rows)
    torch.cuda.synchronize()
    assert sorted_scatter_add.launches == before + 2
    assert torch.equal(got, again)
    ref = sorted_scatter_add_plain(ids, upd.double(), num_rows)
    magnitude = sorted_scatter_add_plain(ids, upd.double().abs(), num_rows)
    assert bool(((got.double() - ref).abs() <= 1e-6 + 1e-5 * magnitude).all())
    # rows that no id names are written as zeros
    absent = torch.bincount(ids, minlength=num_rows) == 0
    assert bool((got[absent] == 0).all())


SORT_CASES = {
    "relations": lambda rng: (rng.integers(0, 237, 8192), 237),
    "entities": lambda rng: (rng.integers(0, 14541, 8192), 14541),
    "large_table": lambda rng: (rng.integers(0, 200000, 8192), 200000),
    "row_sparse_step": lambda rng: (rng.integers(0, 200000, 16642), 200000),
    "twelve_a_thread": lambda rng: (rng.integers(0, 200000, 10240), 200000),
    "all_equal": lambda rng: (np.full(5000, 11), 237),
    "arange": lambda rng: (np.arange(3000), 3000),
    "reversed": lambda rng: (np.arange(3000)[::-1].copy(), 3000),
    "outside": lambda rng: (rng.integers(-40, 300, 4000), 237),
    "single": lambda rng: (np.array([7]), 9),
    "limit": lambda rng: (rng.integers(0, 70000, embedding_ops.SORT_LIMIT), 70000),
    "two_rows": lambda rng: (rng.integers(0, 2, 1500), 2),
}


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("case", sorted(SORT_CASES))
def test_kernel_sort_equals_stable_torch_sort(case, dtype):
    """Launch A's sorted keys, permutation and segment numbers equal a
    stable ``torch.sort``'s exactly (an id outside the table reads as
    ``num_rows``), and the segment sums built on them agree with float64
    within 1e-6 + 1e-5 S, S the segment's sum of |update|."""
    device = _card()
    rng = np.random.default_rng(9)
    ids_np, num_rows = SORT_CASES[case](rng)
    n, D = len(ids_np), 8
    ids64 = torch.tensor(ids_np, dtype=torch.int64, device=device)
    ids = ids64.to(dtype)
    upd = torch.tensor(rng.normal(size=(n, D)).astype(np.float32), device=device)
    outside = (ids64 < 0) | (ids64 >= num_rows)
    keys, order = torch.sort(
        torch.where(outside, torch.full_like(ids64, num_rows), ids64), stable=True)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    seg = torch.cumsum(first, 0) - 1
    assert embedding_ops.sort_route(n) == "kernel"
    before = sorted_scatter_add.torch_sorts
    _, work, _ = embedding_ops.scatter_launch(ids, None, upd, num_rows, phases=1)
    rs, got_seg, gsum = embedding_ops.sorted_segment_sums(ids, upd, num_rows)
    torch.cuda.synchronize()
    assert sorted_scatter_add.torch_sorts == before
    assert torch.equal(work[:n].long(), keys)
    assert torch.equal(work[n:2 * n].long(), order)
    assert torch.equal(work[2 * n:3 * n].long(), seg)
    assert rs.dtype == got_seg.dtype == torch.int32
    assert torch.equal(rs.long(), keys) and torch.equal(got_seg.long(), seg)
    ref = torch.zeros(n, D, dtype=torch.float64, device=device)
    ref.index_add_(0, seg, upd.double()[order])
    mag = torch.zeros_like(ref).index_add_(0, seg, upd.double().abs()[order])
    assert bool(((gsum.double() - ref).abs() <= 1e-6 + 1e-5 * mag).all())
    assert bool((gsum[int(seg[-1]) + 1:] == 0).all())


@pytest.mark.cuda
def test_scatter_above_the_sort_limit_and_strided_ids():
    """One id more than the kernel sorts goes through ``torch.sort`` in the
    wrapper, counted; a column of a batch of triples serves as ids without
    a copy."""
    device = _card()
    rng = np.random.default_rng(10)
    n, num_rows, D = embedding_ops.SORT_LIMIT + 1, 5000, 16
    ids = torch.tensor(rng.integers(0, num_rows, n), device=device)
    upd = torch.tensor(rng.normal(size=(n, D)).astype(np.float32), device=device)
    before = sorted_scatter_add.torch_sorts
    got = sorted_scatter_add(ids, upd, num_rows)
    rs, seg, gsum = embedding_ops.sorted_segment_sums(ids, upd, num_rows)
    torch.cuda.synchronize()
    assert sorted_scatter_add.torch_sorts == before + 2
    ref = sorted_scatter_add_plain(ids, upd.double(), num_rows)
    mag = sorted_scatter_add_plain(ids, upd.double().abs(), num_rows)
    assert bool(((got.double() - ref).abs() <= 1e-6 + 1e-5 * mag).all())
    assert torch.equal(rs.long(), torch.sort(ids, stable=True)[0])
    present = torch.unique(ids)
    assert bool(((gsum[:present.numel()].double() - ref[present]).abs()
                 <= 1e-6 + 1e-5 * mag[present]).all())
    with pytest.raises(ValueError):  # the kernel itself sorts no more than the limit
        embedding_ops.scatter_launch(ids, None, upd, num_rows)
    # ids outside the table read as num_rows and sort last on this route too
    wild = torch.tensor(rng.integers(-40, num_rows + 60, n), device=device)
    outside = (wild < 0) | (wild >= num_rows)
    keys, order = torch.sort(
        torch.where(outside, torch.full_like(wild, num_rows), wild), stable=True)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    want_seg = torch.cumsum(first, 0) - 1
    rs, seg, gsum = embedding_ops.sorted_segment_sums(wild, upd, num_rows)
    got = sorted_scatter_add(wild, upd, num_rows)
    torch.cuda.synchronize()
    assert bool(outside.any()) and int(keys[0]) >= 0
    assert torch.equal(rs.long(), keys) and torch.equal(seg.long(), want_seg)
    sums = torch.zeros(n, D, dtype=torch.float64, device=device)
    sums.index_add_(0, want_seg, upd.double()[order])
    mag = torch.zeros_like(sums).index_add_(0, want_seg, upd.double().abs()[order])
    assert bool(((gsum.double() - sums).abs() <= 1e-6 + 1e-5 * mag).all())
    inside = ~outside
    ref = sorted_scatter_add_plain(wild[inside], upd.double()[inside], num_rows)
    mag = sorted_scatter_add_plain(wild[inside], upd.double().abs()[inside], num_rows)
    assert bool(((got.double() - ref).abs() <= 1e-6 + 1e-5 * mag).all())
    triples = torch.tensor(rng.integers(0, 50, (300, 3)), device=device)
    column = triples[:, 2]
    assert not column.is_contiguous()
    small = upd[:300].contiguous()
    assert torch.equal(sorted_scatter_add(column, small, 50),
                       sorted_scatter_add(column.contiguous(), small, 50))


@pytest.mark.cuda
def test_scatter_kernel_ignores_ids_outside_the_table():
    device = _card()
    ids = torch.tensor([-1, 0, 0, 3, 9, 9], device=device)
    upd = torch.ones(6, 8, device=device)
    got = scatter_add_presorted(ids, torch.arange(6, device=device), upd, 4)
    torch.cuda.synchronize()
    want = torch.zeros(4, 8, device=device)
    want[0], want[3] = 2.0, 1.0
    assert torch.equal(got, want)


def _skewed_ids(rng, n, num_rows):
    """Power-law ids with a share outside the table on either side."""
    w = 1.0 / np.arange(1, num_rows + 1) ** 0.8
    ids = rng.choice(num_rows, n, p=rng.permutation(w / w.sum()))
    ids[rng.random(n) < 0.03] = -7
    ids[rng.random(n) < 0.03] = num_rows + 11
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("num_rows", [237, 14541, 200000])
@pytest.mark.parametrize("n", [255, 256, 257, 513, 8191, 8192, 8193, 32768, 32769,
                               65537])
def test_kernel_sort_at_tile_edges(n, num_rows):
    """Launch A's sort on either side of every tile edge (256 positions a
    round, a second round a tile above 128 x 256): sorted keys, order and
    segment numbers equal a stable torch.sort's in bits, for int64 ids and
    for int32 ids read with a triple's stride, two launches bit-equal; the
    plain model of the blocked sort (``blocked_sort_plain``) gives the same;
    the kernel's plan is the wrapper's ``sort_plan``."""
    import ctypes

    device = _card()
    rng = np.random.default_rng(n + num_rows)
    ids_np = _skewed_ids(rng, n, num_rows)
    ids64 = torch.tensor(ids_np, device=device)
    triples = torch.zeros(n, 3, dtype=torch.int32, device=device)
    triples[:, 1] = ids64.int()
    strided = triples[:, 1]
    assert strided.stride(0) == 3
    upd = torch.zeros(n, 4, device=device)
    outside = (ids64 < 0) | (ids64 >= num_rows)
    keys, order = torch.sort(torch.where(outside, num_rows, ids64), stable=True)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    seg = torch.cumsum(first, 0) - 1
    works = [embedding_ops.scatter_launch(ids, None, upd, num_rows, phases=1)[1][:3 * n]
             for ids in (ids64, ids64, strided)]
    torch.cuda.synchronize()
    want = torch.cat([keys, order, seg]).int()
    for work in works:
        assert torch.equal(work, want)
    plain_keys, plain_order = embedding_ops.blocked_sort_plain(ids64.cpu(), num_rows)
    assert torch.equal(plain_keys, keys.int().cpu())
    assert torch.equal(plain_order, order.int().cpu())
    plan = (ctypes.c_int32 * 4)()
    embedding_ops._scatter_library().scatter_add_sort_plan(
        n, num_rows, ctypes.addressof(plan))
    assert list(plan) == list(embedding_ops.sort_plan(n, num_rows).values())


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("n,num_rows,D", [
    (8192, 14541, 512),   # the main shape: 16-byte rows, 8 bfloat16 columns a thread
    (257, 300, 12),       # 4 bfloat16 columns a thread in 8 bytes
    (513, 40, 7),         # one column a thread
    (129, 14541, 128),    # one tile; most rows zeroed by launch B
    (0, 50, 8),           # no ids: every row zeroed
])
def test_scatter_rows_written_once_on_card(n, num_rows, D, dtype):
    """Every row of the scatter-add written once: a row no id names is +0.0
    in every bit, a row of one update equals that update in bits, the others
    within the float32 rule (1e-6 + 1e-5 S) or two bfloat16 ulps of the
    summed magnitudes S; the segment sums' rows past the last segment zero;
    two launches bit-equal; no torch.sort on the way."""
    device = _card()
    rng = np.random.default_rng(n + D)
    ids = torch.tensor(_skewed_ids(rng, n, num_rows), device=device)
    upd = torch.tensor(rng.normal(size=(n, D)).astype(np.float32), device=device).to(dtype)
    sorts = []
    real_sort = torch.sort
    torch.sort = lambda *a, **k: sorts.append(1) or real_sort(*a, **k)
    try:
        got = sorted_scatter_add(ids, upd, num_rows)
        again = sorted_scatter_add(ids, upd, num_rows)
        rs, seg, gsum = embedding_ops.sorted_segment_sums(ids, upd, num_rows)
        torch.cuda.synchronize()
    finally:
        torch.sort = real_sort
    assert not sorts
    assert got.dtype == dtype and torch.equal(got.view(torch.uint8), again.view(torch.uint8))
    inside = ids[(ids >= 0) & (ids < num_rows)]
    counts = torch.bincount(inside, minlength=num_rows)
    assert bool((got[counts == 0].view(torch.uint8) == 0).all())
    single = torch.nonzero(counts == 1)[:, 0]
    at = torch.nonzero((ids[:, None] == single[None, :]).any(1))[:, 0]
    assert torch.equal(got[ids[at]], upd[at])
    ref = sorted_scatter_add_plain(inside, upd.double()[(ids >= 0) & (ids < num_rows)],
                                   num_rows)
    mag = sorted_scatter_add_plain(inside, upd.double().abs()[(ids >= 0) & (ids < num_rows)],
                                   num_rows)
    tol = 1e-6 + (1e-5 if dtype == torch.float32 else 2.0 ** -7) * mag
    assert bool(((got.double() - ref).abs() <= tol).all())
    segments = int(seg[-1]) + 1 if n else 0
    assert bool((gsum[segments:].float() == 0).all())


@pytest.mark.cuda
def test_gather_backward_runs_the_kernel_on_card():
    device = _card()
    rng = np.random.default_rng(6)
    table = torch.tensor(rng.normal(size=(300, 64)).astype(np.float32),
                         device=device, requires_grad=True)
    ids = torch.tensor(rng.integers(0, 300, (16, 8)), device=device)
    grads = {}
    for mode in ("kernel", "torch"):
        embedding_ops.set_gather_mode(mode)
        before = sorted_scatter_add.launches
        value = torch.sum(torch.sin(embedding_gather(table, ids)) ** 2)
        (grads[mode],) = torch.autograd.grad(value, table)
        assert sorted_scatter_add.launches == before + (mode == "kernel")
    embedding_ops.set_gather_mode("torch")
    torch.testing.assert_close(grads["kernel"], grads["torch"], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_scatter_and_rows_set_raise_instead_of_falling_back():
    device = _card()
    ids = torch.tensor([0, 1], device=device)
    upd = torch.ones(2, 8, device=device)
    with pytest.raises(TypeError):
        sorted_scatter_add(ids, upd.double(), 4)
    with pytest.raises(ValueError):  # on another device
        scatter_add_presorted(ids.cpu(), ids, upd, 4)
    with pytest.raises(ValueError):  # not contiguous
        sorted_scatter_add(ids, torch.ones(8, 2, device=device).t(), 4)
    table = torch.zeros(4, 8, device=device)
    with pytest.raises(TypeError):
        rows_set(table.double(), ids, upd.double())
    with pytest.raises(ValueError):
        rows_set(table, ids, upd.cpu())
    with pytest.raises(ValueError):
        rows_set(table.t().contiguous().t(), ids, torch.ones(2, 4, device=device))


# -- row-write kernel -------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("num_rows,D,m", [(5000, 512, 3000), (40, 64, 2000),
                                          (50, 6, 30), (9, 8, 1)])
def test_rows_set_kernel_is_exact_and_in_place(num_rows, D, m):
    """Duplicate ids carry identical rows, so writers of one row race over
    equal bytes: the result is exact whatever their order."""
    device = _card()
    rng = np.random.default_rng(7)
    table = torch.tensor(rng.normal(size=(num_rows, D)).astype(np.float32),
                         device=device)
    values = torch.tensor(rng.normal(size=(num_rows, D)).astype(np.float32),
                          device=device)
    ids = torch.tensor(rng.integers(0, num_rows, m), device=device)
    want = table.clone()
    want[ids] = values[ids]
    ptr, before = table.data_ptr(), rows_set.launches
    out = rows_set(table, ids, values[ids])
    torch.cuda.synchronize()
    assert rows_set.launches == before + 1
    assert out is table and table.data_ptr() == ptr
    assert torch.equal(table, want)
    # int32 ids serve too
    rows_set(table, ids.int(), values[ids])
    torch.cuda.synchronize()
    assert torch.equal(table, want)


# -- fused row-update kernel ------------------------------------------------------

FUSED_RULES = [
    ("adagrad", {}),
    ("adagrad", {"weight_decay": 0.01, "lr_decay": 0.1}),
    ("adam", {}),
    ("adam", {"weight_decay": 0.01, "betas": (0.8, 0.99), "eps": 1e-6}),
    ("adamw", {"weight_decay": 0.01}),
    ("adamax", {"weight_decay": 0.01}),
    ("sgd", {}),
    ("sgd", {"momentum": 0.9, "dampening": 0.1, "weight_decay": 0.01}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {"weight_decay": 0.01, "momentum": 0.9, "centered": True}),
    ("rmsprop", {}),
    ("adadelta", {"weight_decay": 0.01, "rho": 0.8}),
]


def _fused_case(opt_type, args, rows, D, n, device, seed=0):
    """Parameter, non-zero states, ids with duplicates and row gradients
    whose sign depends on (id, column) only, so that no row's sum cancels:
    a cancelling sum is off by rounding in proportion to the summed
    magnitudes, which Adam's ``m_hat / (sqrt(v_hat) + eps)`` would turn into
    a step of +-lr."""
    from kge_tpu_torch.ops.optim import _RULES

    rng = np.random.default_rng(seed)
    param = torch.tensor(rng.normal(size=(rows, D)).astype(np.float32), device=device)
    states = {
        key: torch.tensor(
            (rng.random((rows, D)) * 0.2 - 0.1 if key in ("m", "momentum", "avg")
             else 0.01 + rng.random((rows, D)) * 0.1).astype(np.float32),
            device=device)
        for key in _RULES[opt_type][0](param[:1], args)
    }
    ids_np = rng.integers(0, max(1, rows // 2), n)
    ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
    sign = ((ids_np[:, None] + np.arange(D)[None, :]) % 2) * 2 - 1
    upd = torch.tensor(((0.1 + rng.random((n, D))) * sign).astype(np.float32),
                       device=device)
    return param, states, ids, upd


@pytest.mark.cuda
@pytest.mark.parametrize("rows,D,n", [(300, 128, 200), (50, 6, 400), (9, 1024, 1)])
@pytest.mark.parametrize("opt_type,args", FUSED_RULES)
def test_fused_update_kernel_matches_plain_on_card(opt_type, args, rows, D, n):
    """Against the plain version in float64: |error| <= 1e-6 + 1e-5 |ref| on
    the parameter and every state, touched rows and untouched; in place;
    bit-equal across two launches; one launch counted per call."""
    from kge_tpu_torch.ops.optim import (
        fused_sorted_update,
        fused_sorted_update_plain,
    )

    device = _card()
    param, states, ids, upd = _fused_case(opt_type, args, rows, D, n, device)
    for step in (0, 3):
        ref_param = param.double()
        ref_states = {k: v.double() for k, v in states.items()}
        fused_sorted_update_plain(opt_type, args, ids, upd.double(), ref_param,
                                  ref_states, 0.01, step)
        runs = []
        for _ in range(2):
            p = param.clone()
            st = {k: v.clone() for k, v in states.items()}
            ptrs = [p.data_ptr()] + [st[k].data_ptr() for k in sorted(st)]
            before = fused_sorted_update.launches
            out = fused_sorted_update(opt_type, args, ids, upd, p, st, 0.01, step)
            torch.cuda.synchronize()
            assert fused_sorted_update.launches == before + 1
            assert out is st
            assert ptrs == [p.data_ptr()] + [st[k].data_ptr() for k in sorted(st)]
            runs.append((p, st))
        (p, st), (p2, st2) = runs
        assert torch.equal(p, p2)
        assert all(torch.equal(st[k], st2[k]) for k in st)
        for got, ref in [(p, ref_param)] + [(st[k], ref_states[k]) for k in st]:
            err = (got.double() - ref).abs()
            assert bool((err <= 1e-6 + 1e-5 * ref.abs()).all()), float(err.max())


@pytest.mark.cuda
def test_fused_update_without_updates_and_ids_outside_the_table():
    """No row gradient at all is the dense rule with a zero gradient; ids
    outside the table are skipped, as the scatter kernel skips them."""
    from kge_tpu_torch.ops.optim import (
        fused_sorted_update,
        fused_sorted_update_plain,
    )

    device = _card()
    param, states, ids, upd = _fused_case("adam", {}, 40, 16, 10, device)
    want_p, want_s = param.clone(), {k: v.clone() for k, v in states.items()}
    fused_sorted_update_plain("adam", {}, ids[:0], upd[:0], want_p, want_s, 0.01, 2)
    got_p, got_s = param.clone(), {k: v.clone() for k, v in states.items()}
    fused_sorted_update("adam", {}, ids[:0], upd[:0], got_p, got_s, 0.01, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_p, want_p, rtol=1e-5, atol=1e-6)
    assert not torch.equal(got_p, param)  # the moments moved every row
    inside = ids < 15
    want_p, want_s = param.clone(), {k: v.clone() for k, v in states.items()}
    fused_sorted_update_plain("adam", {}, ids[inside], upd[inside], want_p, want_s,
                              0.01, 2)
    shifted = torch.where(inside, ids, ids + 1000)
    shifted[(~inside).nonzero().flatten()[::2]] = -3
    got_p, got_s = param.clone(), {k: v.clone() for k, v in states.items()}
    fused_sorted_update("adam", {}, shifted, upd, got_p, got_s, 0.01, 2)
    torch.cuda.synchronize()
    torch.testing.assert_close(got_p, want_p, rtol=1e-5, atol=1e-6)
    for key in want_s:
        torch.testing.assert_close(got_s[key], want_s[key], rtol=1e-5, atol=1e-6)


@pytest.mark.cuda
def test_fused_update_raises_instead_of_falling_back():
    from kge_tpu_torch.ops.optim import fused_sorted_update

    device = _card()
    param, states, ids, upd = _fused_case("adam", {}, 40, 16, 10, device)
    with pytest.raises(TypeError):
        fused_sorted_update("adam", {}, ids, upd.double(), param.double(),
                            {k: v.double() for k, v in states.items()}, 0.01, 0)
    with pytest.raises(ValueError):  # on another device
        fused_sorted_update("adam", {}, ids.cpu(), upd, param, states, 0.01, 0)
    with pytest.raises(ValueError):  # a state of another shape
        fused_sorted_update("adam", {}, ids, upd, param,
                            {"m": states["m"], "v": states["v"][:5]}, 0.01, 0)
    with pytest.raises(ValueError):  # not contiguous
        fused_sorted_update("adam", {}, ids, upd, param,
                            {"m": states["m"], "v": states["v"].t().contiguous().t()},
                            0.01, 0)


# -- pooled distance kernels --------------------------------------------------------


def _pooled_reference(queries, pools, sel, F, kind, g):
    """Scores and gradients of the plain version in float64, where a sel
    outside [0, F) stands for a zero candidate and no pool row: the plain
    version on pools with a zero row appended to every group."""
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores_plain

    n, K = sel.shape
    d = queries[0].shape[1]
    inside = (sel >= 0) & (sel < F)
    sel_z = torch.where(inside, sel, torch.full_like(sel, F))
    q64 = [q.double().requires_grad_(True) for q in queries]
    p64 = [torch.cat([p.double().reshape(K, F, d),
                      torch.zeros(K, 1, d, dtype=torch.float64, device=p.device)], 1)
           .reshape(K * (F + 1), d).requires_grad_(True) for p in pools]
    ref = pooled_dist_scores_plain(q64, p64, sel_z, F + 1, kind)
    grads = torch.autograd.grad(ref, q64 + p64, g.double(), allow_unused=True)
    parts = len(queries)
    dqs = [torch.zeros_like(q) if dq is None else dq for q, dq in zip(q64, grads[:parts])]
    dpools = [dp.reshape(K, F + 1, d)[:, :F].reshape(K * F, d) for dp in grads[parts:]]
    rows = torch.arange(K, device=sel.device)[None, :] * F + sel.long()
    mag_pool = torch.zeros(K * F, dtype=torch.float64, device=sel.device).index_add_(
        0, rows[inside], g.double().abs()[inside])
    return ref.detach(), dqs + dpools, g.double().abs().sum(dim=1), mag_pool


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,F,d,outside", [
    (64, 16, 4, 128, False), (37, 5, 3, 100, False), (9, 130, 2, 51, False),
    (200, 8, 8, 512, False),
    (256, 1024, 8, 64, False),   # K = 1,024
    (1000, 128, 8, 128, False),  # several row chunks, n no multiple of one
    (300, 13, 8, 300, False),    # K no multiple of a block's 8 slots; 3 tiles
    (500, 64, 1, 128, False), (500, 40, 16, 192, False),  # F = 1 and F = 16
    (200, 6, 100, 128, False),   # dq's pool groups too large to stage
    (300, 24, 8, 128, True),     # sel outside [0, F)
    (0, 16, 4, 64, False),       # no rows
    # the forward's edges: n and K one past a block's 256 rows and 16 slots,
    # d = 132 in five 32-column tiles (the last of one vector); F = 24
    # staged for l1 and not for cmod; F = 60 from L2 for both
    (257, 17, 8, 132, False), (300, 20, 24, 64, False), (150, 9, 60, 40, False),
])
@pytest.mark.parametrize("kind", ["l1", "cmod"])
def test_pooled_kernels_match_plain_on_card(kind, n, K, F, d, outside):
    """Scores, dq and dpool against the plain version in float64: |error| <=
    1e-6 + 1e-5 x the sum of magnitudes an element adds up; bit-equal across
    two launches; one backward launch counted per call, and one forward
    launch where there are rows."""
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores

    device = _card()
    rng = np.random.default_rng(8)
    parts = 1 if kind == "l1" else 2
    queries = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(parts)]
    pools = [rng.normal(size=(K * F, d)).astype(np.float32) for _ in range(parts)]
    sel = rng.integers(0, F, (n, K)).astype(np.int32)
    for i, j in ((0, 1), (3, K - 1)):  # distance exactly 0
        if i < n:
            for q, pool in zip(queries, pools):
                q[i] = pool[j * F + sel[i, j]]
    if outside:
        sel[rng.random((n, K)) < 0.1] = -1
        sel[rng.random((n, K)) < 0.1] = F
        sel[rng.random((n, K)) < 0.05] = F + 7
    g = torch.tensor(rng.normal(size=(n, K)).astype(np.float32), device=device)
    sel = torch.tensor(sel, device=device)
    runs = []
    for _ in range(2):
        leaves = [torch.tensor(a, device=device, requires_grad=True)
                  for a in queries + pools]
        before = (pooled_dist_scores.launches, pooled_dist_scores.backward_launches)
        out = pooled_dist_scores(leaves[:parts], leaves[parts:], sel, F, kind)
        grads = torch.autograd.grad(out, leaves, g)
        torch.cuda.synchronize()
        assert (pooled_dist_scores.launches,
                pooled_dist_scores.backward_launches) == (before[0] + (n > 0),
                                                          before[1] + 1)
        runs.append((out.detach(), grads))
    (out, grads), (out2, grads2) = runs
    assert out.shape == (n, K)
    assert torch.equal(out, out2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    ref, ref_grads, mag_q, mag_pool = _pooled_reference(
        [torch.tensor(q, device=device) for q in queries],
        [torch.tensor(p, device=device) for p in pools], sel, F, kind, g)
    assert bool(((out.double() - ref).abs() <= 1e-6 + 1e-5 * ref.abs()).all())
    if n > 0 and not outside:
        assert float(out[0, 1].abs()) <= 1.01e-15 * d
    for index, (got, want) in enumerate(zip(grads, ref_grads)):
        mag = mag_q if index < parts else mag_pool
        assert torch.isfinite(got).all()
        assert bool(((got.double() - want).abs() <= 1e-6 + 1e-5 * mag[:, None]).all())


@pytest.mark.cuda
def test_pooled_scores_keep_sqrtf_at_infinite_terms():
    """``cmod`` terms of +inf (a difference whose square overflows) and NaN
    give the scores that sqrtf gives, as the plain version in float32 does:
    -inf and NaN in the same places; every other score within 1e-6 + 1e-5
    |ref| of float64."""
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores, pooled_dist_scores_plain

    device = _card()
    rng = np.random.default_rng(9)
    n, K, F, d = 40, 20, 4, 36
    queries = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(2)]
    pools = [rng.normal(size=(K * F, d)).astype(np.float32) for _ in range(2)]
    queries[0][3, 5] = 3e19        # every pair of row 3: an infinite term
    queries[1][7, 0] = np.nan      # every pair of row 7: NaN
    pools[0][2 * F + 1, 7] = -3e19  # the pairs (i, 2) that select it
    sel = torch.tensor(rng.integers(0, F, (n, K)).astype(np.int32), device=device)
    qs = [torch.tensor(q, device=device) for q in queries]
    ps = [torch.tensor(p, device=device) for p in pools]
    out = pooled_dist_scores(qs, ps, sel, F, "cmod")
    plain = pooled_dist_scores_plain(qs, ps, sel, F, "cmod")
    assert bool(torch.isinf(plain).any()) and bool(torch.isnan(plain).any())
    assert torch.equal(torch.isnan(out), torch.isnan(plain))
    assert torch.equal(torch.isinf(out), torch.isinf(plain))
    assert torch.equal(out[torch.isinf(out)], plain[torch.isinf(plain)])
    finite = torch.isfinite(plain)
    ref = pooled_dist_scores_plain([q.double() for q in qs], [p.double() for p in ps],
                                   sel, F, "cmod")
    assert bool(((out.double() - ref).abs() <= 1e-6 + 1e-5 * ref.abs())[finite].all())


@pytest.mark.cuda
def test_pooled_kernels_raise_instead_of_falling_back():
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores

    device = _card()
    q = torch.zeros(4, 8, device=device)
    pool = torch.zeros(8, 8, device=device)
    sel = torch.zeros(4, 4, dtype=torch.int32, device=device)
    with pytest.raises(TypeError):
        pooled_dist_scores([q.double()], [pool.double()], sel, 2, "l1")
    with pytest.raises(ValueError):  # on another device
        pooled_dist_scores([q], [pool.cpu()], sel, 2, "l1")
    with pytest.raises(ValueError):  # rows without unit stride
        pooled_dist_scores([q], [torch.zeros(8, 8, device=device).t()], sel, 2, "l1")


# -- per-row picks and the negative-sampling routes --------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("n,V,K", [(8192, 14541, 128), (64, 5, 256)])
def test_picked_scores_backward_is_bit_equal_on_card(n, V, K):
    """``picked_scores`` takes the same values as a gather on the CPU, and
    its backward sums the repeated columns of a row in one order: two
    launches give the same bits, on cases with a column picked three times
    or more in one row, within float32 rounding of the float64 sum."""
    from kge_tpu_torch.ops.pick import picked_scores

    device = _card()
    generator = torch.Generator(device=device).manual_seed(n)
    S = torch.randn((n, V), generator=generator, device=device)
    idx = torch.randint(0, V, (n, K), generator=generator, device=device)
    idx[:, 1] = idx[:, 0]
    idx[:, 2] = idx[:, 0]
    g = torch.randn((n, K), generator=generator, device=device)
    grads = []
    for _ in range(2):
        St = S.clone().requires_grad_(True)
        out = picked_scores(St, idx)
        assert torch.equal(out.cpu(), torch.gather(S.cpu(), 1, idx.cpu()))
        (grad,) = torch.autograd.grad(out, St, g)
        grads.append(grad)
    assert torch.equal(grads[0], grads[1])
    want = torch.zeros((n, V), dtype=torch.float64)
    want.index_put_((torch.arange(n)[:, None].expand_as(idx), idx.cpu()),
                    g.cpu().double(), accumulate=True)
    err = (grads[0].cpu().double() - want).abs()
    assert bool((err <= 1e-6 + 1e-5 * want.abs()).all())


def _negative_sampling_job(data, device, params=None, **extra):
    """A prepared ComplEx negative-sampling job on ``data`` (d = 32, batch
    64, 16 per-row negatives per slot, KL, Adagrad), with ``params`` or
    weights from a seed; returns the job and its weights as kge_tpu's
    tree."""
    from kge_tpu_torch import Config, Dataset
    from kge_tpu_torch.job import TrainingJob
    from kge_tpu_torch.models import KgeModel, load_jax_params, to_jax_params

    config = Config()
    config.load_options({"model": "complex"})
    for key, value in {
        "lookup_embedder.dim": 32, "job.device": device, "dataset.name": str(data),
        "train.type": "negative_sampling", "train.batch_size": 64, "train.loss": "kl",
        "train.optimizer.default.type": "Adagrad",
        "train.optimizer.default.args.lr": 0.1,
        "train.optimizer.default.args.initial_accumulator_value": 0.1,
        "negative_sampling.shared": False, "negative_sampling.num_samples.s": 16,
        "negative_sampling.num_samples.o": 16, "valid.every": 0,
        "random_seed.default": 0, "console.quiet": True, **extra,
    }.items():
        config.set(key, value, create=True)
    dataset = Dataset.create(config, folder=str(data))
    model = KgeModel.create(config, dataset, init_for_load_only=True)
    if params is None:
        model.init_params(torch.Generator(device=model.device).manual_seed(8))
        params = to_jax_params(model)
    load_jax_params(model, params)
    job = TrainingJob.create(config, dataset, model=model)
    job._prepare()
    job._is_prepared = True
    return job, params


def _one_step(job, arrays):
    batch = {k: torch.as_tensor(v).to(job.device) for k, v in arrays.items()}
    cost, _ = job._train_step(batch, job._current_lrs())
    return float(cost), [p.detach().cpu().clone() for p in job.optimizer.params]


def _per_row_batch(job, seed):
    rng = np.random.default_rng(seed)
    batch = next(iter(job._batches()))
    arrays = {"triples": batch["triples"], "mask": batch["mask"]}
    for slot in (0, 2):
        arrays[f"neg_samples_{slot}"] = rng.integers(0, 300, (64, 16))
        arrays[f"neg_samples_{slot}"][:, 1:3] = arrays[f"neg_samples_{slot}"][:, :1]
    return arrays


def _close(a, b):
    for x, y in zip(a, b):
        assert bool(((x - y).abs() <= 1e-6 + 1e-5 * y.abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("sparse", ["never", "always"])
def test_per_row_routes_agree_on_card(tmp_path, sparse):
    """The same per-row samples scored by ``all`` (dense step only),
    ``batch`` and ``triple`` give the same loss (rtol 1e-5) and the same
    tables after one step (atol 1e-6 + rtol 1e-5), and ``batch`` on the card
    gives the CPU's."""
    _card()
    data = tmp_path / "routes_synth"
    _write_dataset(data, 9)
    results, params = {}, None
    routes = ("batch", "triple") if sparse == "always" else ("all", "batch", "triple")
    for route in routes:
        job, params = _negative_sampling_job(
            data, "cuda", params, **{"negative_sampling.implementation": route,
                                     "train.sparse_embedding_update": sparse})
        assert job._sparse_update == (sparse == "always")
        results[route] = _one_step(job, _per_row_batch(job, 1))
    host, _ = _negative_sampling_job(
        data, "cpu", params, **{"negative_sampling.implementation": "batch",
                                "train.sparse_embedding_update": sparse})
    results["cpu"] = _one_step(host, _per_row_batch(host, 1))
    for route, (cost, tables) in results.items():
        np.testing.assert_allclose(cost, results["batch"][0], rtol=1e-5, err_msg=route)
        _close(tables, results["batch"][1])


@pytest.mark.cuda
def test_fused_and_subbatched_steps_on_card(tmp_path):
    """On the card, the fused step and a step in subbatches of 16 against
    the plain dense step from the same weights and samples."""
    _card()
    data = tmp_path / "fused_synth"
    _write_dataset(data, 10)
    results, params = {}, None
    for name, extra in (("dense", {}),
                        ("fused", {"negative_sampling.fused_scoring": "always"}),
                        ("subbatched", {"train.subbatch_size": 16})):
        job, params = _negative_sampling_job(
            data, "cuda", params, **{"negative_sampling.implementation": "batch",
                                     "train.sparse_embedding_update": "never", **extra})
        results[name] = _one_step(job, _per_row_batch(job, 2))
    for name, (cost, tables) in results.items():
        np.testing.assert_allclose(cost, results["dense"][0], rtol=1e-5, err_msg=name)
        _close(tables, results["dense"][1])


def _conve_model(data, device, params=None, **extra):
    """A reciprocal ConvE at d = 200 (10 x 20 maps, D = 201 with the bias
    column) on ``data`` and ``device``, every dropout 0, with ``params`` or
    weights drawn from a seed and random batch-norm statistics; returns the
    config, the dataset, the model and its weights as kge_tpu's tree."""
    from kge_tpu_torch import Config, Dataset
    from kge_tpu_torch.models import KgeModel, load_jax_params, to_jax_params

    config = Config()
    config.load_options({"model": "reciprocal_relations_model"})
    for key, value in {
        "reciprocal_relations_model.base_model.type": "conve",
        "conve.entity_embedder.dim": 200, "conve.relation_embedder.dim": 200,
        "conve.entity_embedder.dropout": 0.0, "conve.relation_embedder.dropout": 0.0,
        "conve.feature_map_dropout": 0.0, "conve.projection_dropout": 0.0,
        "job.device": device, "dataset.name": str(data), "valid.every": 0,
        "random_seed.default": 0, "console.quiet": True, **extra,
    }.items():
        config.set(key, value, create=True)
    dataset = Dataset.create(config, folder=str(data))
    model = KgeModel.create(config, dataset, init_for_load_only=True)
    if params is None:
        model.init_params(torch.Generator(device=model.device).manual_seed(5))
        params = to_jax_params(model)
        rng = np.random.default_rng(6)
        for key, value in params["scorer"].items():
            if key.startswith("bn"):
                low, high = (0.5, 1.5) if key.endswith("_var") else (-0.1, 0.1)
                params["scorer"][key] = rng.uniform(
                    low, high, value.shape).astype(np.float32)
    load_jax_params(model, params)
    return config, dataset, model, params


@pytest.mark.cuda
def test_conve_rank_kernel_matches_plain_on_card(tmp_path):
    """ConvE's evaluation queries ([1 | h], D = 201: the kernel's 4-byte copy
    route) ranked by the kernel and by its plain version on the card: equal
    counts, label values within rtol 1e-5, the pivot ties with itself; the
    kernel launches once a direction of a batch."""
    from kge_tpu_torch.job import EvaluationJob

    device = _card()
    data = tmp_path / "conve_synth"
    _write_dataset(data, 12)
    config, dataset, model, _ = _conve_model(
        data, "cuda", **{"eval.batch_size": 64, "eval.split": "test"})
    job = EvaluationJob.create(config, dataset, model=model)
    model.eval()  # as the job's run() sets it: the factorization is eval-only
    with torch.inference_mode():
        job._prepare()
        before = fused_rank_counts.launches
        job._evaluate()
        assert fused_rank_counts.launches - before == 2 * 2  # 100 triples, 64 a batch
        _, device_batches = job._collate_cache
        for triples, labels in device_batches:
            fac = model.factorized_queries(triples, (0, 2))
            for key, slot in (("o", 2), ("s", 0)):
                _, q, targets, score_map = fac[slot]
                assert q.shape[1] == targets.shape[1] == 201 and score_map is None
                row_ptr, cols, _, _ = labels[key]
                true = triples[:, slot].to(torch.int32).contiguous()
                g, c, vals, pivot = fused_rank_counts(
                    q.contiguous(), targets.contiguous(), None, row_ptr, cols,
                    300, ATOL, RTOL, pivot_cols=true)
                pg, pc, pvals, _ = rank_kernel.fused_rank_counts_plain(
                    q, targets, pivot, row_ptr, cols, 300, ATOL, RTOL)
                assert torch.equal(g, pg) and torch.equal(c, pc)
                np.testing.assert_allclose(vals.cpu().numpy(), pvals.cpu().numpy(),
                                           rtol=1e-5, atol=1e-6)
                assert bool((c >= 1).all())


@pytest.mark.cuda
@pytest.mark.parametrize("train_type", ["KvsAll", "1vsAll"])
def test_conve_step_on_card_equals_cpu(tmp_path, train_type):
    """One training step of reciprocal ConvE (d = 200, batch 64, Adagrad
    with initial accumulator 0.1, so that the rounding noise that the
    biases before batch norm get as gradient moves them by little, not by
    +-lr) on the card and on the CPU from the same weights and batch: losses
    within rtol 1e-5; tables, scorer parameters and batch-norm statistics
    within 1e-5 + 1e-4 |CPU| (cuDNN sums the convolution's gradients in
    another order than the CPU, and batch norm divides the difference by
    the batch's spread); the scatter kernel launches 2 (KvsAll) or 4
    (1vsAll) times."""
    _card()
    data = tmp_path / "conve_step"
    _write_dataset(data, 13)
    extra = {"train.type": train_type, "train.batch_size": 64,
             "train.loss": "bce" if train_type == "KvsAll" else "kl",
             "train.optimizer.default.type": "Adagrad",
             "train.optimizer.default.args.lr": 0.1,
             "train.optimizer.default.args.initial_accumulator_value": 0.1}
    from kge_tpu_torch.job import TrainingJob

    results, params = {}, None
    for where in ("cuda", "cpu"):
        config, dataset, model, params = _conve_model(data, where, params, **extra)
        job = TrainingJob.create(config, dataset, model=model)
        job._prepare()
        job._is_prepared = True
        batch = next(iter(job._batches()))
        variant = job._step_variant(batch)
        before = sorted_scatter_add.launches
        tensors = {k: torch.as_tensor(v).to(job.device) for k, v in batch.items()
                   if k != "true_size" and not isinstance(v, str)}
        cost, _ = job._train_step(tensors, job._current_lrs(), variant)
        if where == "cuda":
            assert sorted_scatter_add.launches - before == (
                2 if train_type == "KvsAll" else 4)
        results[where] = (float(cost), [p.detach().cpu().clone()
                                        for p in job.optimizer.params])
    np.testing.assert_allclose(results["cuda"][0], results["cpu"][0], rtol=1e-5)
    for got, want in zip(results["cuda"][1], results["cpu"][1], strict=True):
        assert bool(((got - want).abs() <= 1e-5 + 1e-4 * want.abs()).all())


# -- the bfloat16 paths of the six kernels (parallel.*_dtype: bfloat16) ------------


def _bf16(rng, *shape, scale=1.0, device="cuda"):
    return torch.tensor(rng.normal(0.0, scale, shape).astype(np.float32),
                        device=device).bfloat16()


def _within(got, want, bound):
    """|got - want| <= bound elementwise, NaNs where both are NaN."""
    got, want = got.float(), want.float()
    both_nan = torch.isnan(got) & torch.isnan(want)
    return bool(torch.all(both_nan | ((got - want).abs() <= bound)))


def _bf16_rank_outputs_equal(got, want):
    """Counts equal, vals and pivots (bfloat16) equal in bits."""
    return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2].view(torch.int16), want[2].view(torch.int16))
            and torch.equal(got[3].view(torch.int16), want[3].view(torch.int16)))


def _undecided_by_the_rule(q, T, num_valid, pivot, score_map):
    """The entries that the certificate leaves open by the PyTorch rule,
    on the kernel's own tensor-core sums and norm bounds."""
    sums, nq, nt = rank_kernel.tc_tile_sums(q, T[:num_valid])
    bound = rank_kernel.certificate_bound(nq, nt, q.shape[1])
    cats = rank_kernel.certified_categories(sums, bound, pivot, ATOL, RTOL,
                                            score_map)
    return int((cats < 0).sum())


def _check_certified_rank(q, T, row_ptr, cols, num_valid, true, score_map):
    """K1's bfloat16 (or float16: q's dtype) path against its plain version:
    counts equal, vals and pivots bit for bit; two launches and the plans
    of 1, 3 and every range equal in bits; the undecided entries those of
    the rule. Returns the kernel's count of undecided entries."""
    before = fused_rank_counts.launches

    def run(plan=None):
        out = fused_rank_counts(q, T, None, row_ptr, cols, num_valid, ATOL,
                                RTOL, score_map=score_map, pivot_cols=true,
                                plan=plan)
        torch.cuda.synchronize()
        return out

    first = run()
    assert fused_rank_counts.launches == before + 1
    assert first[2].dtype == first[3].dtype == q.dtype
    recounted = int(fused_rank_counts.last_recounted)
    plain = rank_kernel.fused_rank_counts_plain(
        q, T, None, row_ptr, cols, num_valid, ATOL, RTOL, score_map=score_map,
        pivot_cols=true)
    assert _bf16_rank_outputs_equal(first, plain)
    n = q.shape[0]
    for plan in (None, rank_kernel.rank_plan(n, num_valid, num_ranges=1),
                 rank_kernel.rank_plan(n, num_valid, num_ranges=3),
                 rank_kernel.rank_plan(n, num_valid, num_ranges=num_valid)):
        assert _bf16_rank_outputs_equal(run(plan), first), plan
        assert int(fused_rank_counts.last_recounted) == recounted
    assert recounted == _undecided_by_the_rule(q, T, num_valid, first[3],
                                               score_map)
    return recounted


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", [None, "l2"])
@pytest.mark.parametrize("D", [30, 64, 132, 201, 320, 512])
@pytest.mark.parametrize("n", [1, 70, 256])
def test_bf16_rank_kernel_counts_equal_plain_on_card(n, D, epilogue):
    """K1's bfloat16 path (tensor-core tiles, certified decisions, the
    chain for the rest): the counts equal the plain version's exactly, and
    vals and the pivot bit for bit (one float32 chain per score, one
    rounding, the tie test in bfloat16 on both sides), across launches and
    plans, at every staging width (D of 30, 201: plain loads; 132: 8-byte
    copies; the others 16-byte), with num_valid not a multiple of 128."""
    device = _card()
    E, num_valid = 1000, 937
    q, T, row_ptr, cols, true = (x.to(device) for x in _inputs(7, n, E, D))
    q, T = q.bfloat16(), T.bfloat16()
    true = true % num_valid
    score_map = rank_kernel.NEG_SQRT_L2 if epilogue else None
    recounted = _check_certified_rank(q, T, row_ptr, cols, num_valid, true,
                                      score_map)
    if n > 5:  # the NaN and infinite rows of _inputs are recomputed whole
        assert recounted >= 2 * num_valid


def _certified_rank_case(case, n=70, E=1000, D=64):
    rng = np.random.default_rng(len(case))
    if case == "subnormals":  # float16 subnormals in every third row of q
        rng = np.random.default_rng(3)
    q = rng.normal(0, 0.3, (n, D))
    T = rng.normal(0, 0.3, (E, D))
    true = rng.integers(0, E // 2, n)
    if case == "ties":
        # copies of row 0's true row whose first coordinate steps by 2^-12
        # (exact in bfloat16) through row 0's pivot, 0 (q[0] picks that
        # coordinate), and the true row repeated as odd rows' true column
        T[true[0], 0] = 0.0
        T[E // 2:] = T[true[0]]
        T[E // 2:, 0] = (np.arange(E - E // 2) - (E - E // 2) // 2) * 2.0 ** -12
        true[1::2] = E // 2 + 7
        q[0] = 0.0
        q[0, 0] = 1.0
    elif case == "cancellation":
        q = np.repeat(np.abs(q[:, :1]), D, axis=1) * 4.0 + q * 1e-2
        T = np.where(np.arange(D) % 2 == 0, 1.0, -1.0) * rng.uniform(
            0.5, 2.0, (E, 1)) + rng.normal(0, 1e-2, (E, D))
    elif case == "zero_rows":
        q[::2] = 0.0
        T *= 1e-4
    elif case == "nonfinite":
        q[1, 3], q[2, 0], q[3, 5] = np.inf, -np.inf, np.nan
        T[true[4], 2], T[true[6], 1], T[9, 9], T[11, 0] = np.inf, np.nan, -np.inf, np.inf
    elif case == "infinite_rows":
        q[:, 0] = np.inf
    elif case == "subnormals":
        # below 2^-14 in float16: every third query row and every fifth
        # candidate row hold many, the others some
        q[::3] *= 2.0 ** -14
        T[::5] *= 2.0 ** -14
        q[:, ::9] *= 2.0 ** -12
        T[:, ::7] *= 2.0 ** -12
    per_row = [np.sort(rng.choice(E, size=int(rng.integers(0, 30)), replace=False))
               for _ in range(n)]
    row_ptr = np.concatenate([[0], np.cumsum([len(c) for c in per_row])])
    return [torch.tensor(a, dtype=dt) for a, dt in (
        (q, torch.float32), (T, torch.float32), (row_ptr, torch.int32),
        (np.concatenate(per_row), torch.int32), (true, torch.int32))]


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [None, 64])
@pytest.mark.parametrize("epilogue", [None, "l2"])
@pytest.mark.parametrize("case", ["ties", "cancellation", "zero_rows", "nonfinite",
                                  "infinite_rows"])
def test_bf16_rank_kernel_data_cases_on_card(case, epilogue, capacity,
                                             monkeypatch):
    """K1's bfloat16 path where the certificate is hard: many bfloat16 ties
    (duplicated candidates, the true row repeated, sums stepping across the
    pivot's buckets: some entries are recounted), cancelling products,
    zero queries (pivots in the atol region), infinities and NaN in q and
    in t, and an infinity in every query row (every entry recounted); with
    the default worklist and with one of 64 entries, so that blocks that
    find it full recount their entries themselves."""
    device = _card()
    if capacity is not None:
        monkeypatch.setattr(rank_kernel, "RECOUNT_CAPACITY", capacity)
    E, num_valid = 1000, 997
    q, T, row_ptr, cols, true = (x.to(device) for x in _certified_rank_case(case))
    q, T = q.bfloat16(), T.bfloat16()
    score_map = rank_kernel.NEG_SQRT_L2 if epilogue else None
    recounted = _check_certified_rank(q, T, row_ptr, cols, num_valid, true,
                                      score_map)
    if case == "ties":
        assert recounted > 0
    if case == "infinite_rows":
        assert recounted == q.shape[0] * num_valid


@pytest.mark.cuda
def test_bf16_rank_tiles_run_on_the_tensor_cores():
    """The built library's bfloat16 tile kernel holds HMMA (or HGMMA)
    instructions, and the float32 tile kernel none."""
    import re
    import shutil
    import subprocess

    from kge_tpu_torch.ops import kernel_utils

    _card()
    path = kernel_utils.build("rank_counts")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    sections = [s.split("\n", 1) for s in re.split(r"\n\s*Function : ", sass)[1:]]
    tc = [body for name, body in sections if "rank_tiles_tc_kernel" in name]
    fp32 = [body for name, body in sections if "rank_tiles_kernel" in name]
    assert tc and fp32
    assert all(re.search(r"\bH(G)?MMA\b", body) for body in tc)
    assert not any(re.search(r"\bH(G)?MMA\b", body) for body in fp32)


@pytest.mark.cuda
@pytest.mark.parametrize("subnormals", [False, True], ids=["plain", "subnormals"])
@pytest.mark.parametrize("epilogue", [None, "l2"])
@pytest.mark.parametrize("D", [30, 64, 132, 201, 320, 512])
@pytest.mark.parametrize("n", [1, 70, 256])
def test_f16_rank_kernel_certified_counts_equal_plain_on_card(n, D, epilogue,
                                                              subnormals):
    """K1's float16 path (the bfloat16 path's tensor-core tiles and
    certificate over float16): the counts equal the plain version's
    exactly, vals and the pivot bit for bit, across launches and plans, at
    every staging width, and the entries left open are the rule's; with
    ``subnormals`` a quarter of every row's entries scaled below 2^-14
    (float16 subnormals in every row of q and of the candidates), which the
    tensor cores read exactly, so their rows are not recounted whole."""
    device = _card()
    E, num_valid = 1000, 937
    q, T, row_ptr, cols, true = (x.to(device) for x in _inputs(7, n, E, D))
    if subnormals:
        q[:, ::4] *= 2.0 ** -14
        T[:, 1::4] *= 2.0 ** -14
    q, T = q.half(), T.half()
    if subnormals:
        tiny = (q != 0) & (q.abs() < 2.0 ** -14)
        assert bool(tiny[torch.isfinite(q).all(1)].any(1).all())
    true = true % num_valid
    score_map = rank_kernel.NEG_SQRT_L2 if epilogue else None
    before = fused_rank_counts.f16_launches
    recounted = _check_certified_rank(q, T, row_ptr, cols, num_valid, true,
                                      score_map)
    assert fused_rank_counts.f16_launches == before + 5
    if n > 5:  # the NaN and infinite rows of _inputs are recomputed whole
        assert recounted >= 2 * num_valid
        assert recounted < 0.05 * n * num_valid


@pytest.mark.cuda
@pytest.mark.parametrize("capacity", [None, 64])
@pytest.mark.parametrize("epilogue", [None, "l2"])
@pytest.mark.parametrize("case", ["ties", "cancellation", "zero_rows", "nonfinite",
                                  "infinite_rows", "subnormals"])
def test_f16_rank_kernel_data_cases_on_card(case, epilogue, capacity,
                                            monkeypatch):
    """The bfloat16 data cases in float16 (the ties step by 2^-12, exact in
    float16 too; zero_rows' candidates of 1e-4 are float16 subnormals),
    and rows whose values lie below 2^-14 (``subnormals``): counts, vals
    and pivots equal the plain version's, the entries left open are the
    rule's, with the default worklist and with one of 64 entries."""
    device = _card()
    if capacity is not None:
        monkeypatch.setattr(rank_kernel, "RECOUNT_CAPACITY", capacity)
    E, num_valid = 1000, 997
    q, T, row_ptr, cols, true = (x.to(device) for x in _certified_rank_case(case))
    q, T = q.half(), T.half()
    score_map = rank_kernel.NEG_SQRT_L2 if epilogue else None
    recounted = _check_certified_rank(q, T, row_ptr, cols, num_valid, true,
                                      score_map)
    if case == "infinite_rows":
        assert recounted == q.shape[0] * num_valid
    if case == "subnormals":
        assert recounted < 0.05 * q.shape[0] * num_valid


@pytest.mark.cuda
def test_f16_rank_tiles_run_on_the_tensor_cores():
    """The built library's float16 tile kernel holds HMMA (or HGMMA)
    instructions, and no float16 instantiation of the float32 tile kernel
    is left."""
    import re
    import shutil
    import subprocess

    from kge_tpu_torch.ops import kernel_utils

    _card()
    path = kernel_utils.build("rank_counts")
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    sections = [s.split("\n", 1) for s in re.split(r"\n\s*Function : ", sass)[1:]]
    tc = [body for name, body in sections
          if "rank_tiles_tc_kernel" in name and "6__half" in name]
    assert tc and all(re.search(r"\bH(G)?MMA\b", body) for body in tc)
    assert not any("rank_tiles_kernel" in name and "__half" in name
                   for name, _ in sections)


@pytest.mark.cuda
def test_f16_tensor_core_products_are_exact_on_card():
    """Every ordered pair of float16 values (2^32) through mma.sync
    m16n8k16, one product an accumulator: each sum equals the exact
    float32 product, where neither, one or both operands are subnormal;
    the tensor cores flush no float16 subnormal (the finding the float16
    norm bound rests on)."""
    counts = rank_kernel.f16_subnormal_check(_card())
    torch.cuda.synchronize()
    normal, subnormal = 65536 - 2046, 2046
    assert (counts["pairs_normal"], counts["pairs_one_subnormal"],
            counts["pairs_both_subnormal"]) == (
        normal * normal, 2 * normal * subnormal, subnormal * subnormal)
    assert {k: v for k, v in counts.items() if not k.startswith("pairs")} == {
        "differ_normal": 0, "differ_one_subnormal": 0,
        "differ_both_subnormal": 0, "flushed": 0}


@pytest.mark.cuda
def test_bf16_scatter_and_rows_set_match_plain_on_card():
    """K2's bfloat16 path within two bfloat16 ulps of each row's summed
    magnitude of the plain version (both sum in float32, in other orders,
    and round once); the segment sums the same; K3 bit for bit, in place."""
    from kge_tpu_torch.ops.embedding_ops import sorted_segment_sums

    device = _card()
    rng = np.random.default_rng(11)
    for n, rows, D in ((8192, 14541, 512), (129, 237, 30)):
        ids = torch.tensor(rng.integers(0, rows, n), device=device)
        upd = _bf16(rng, n, D)
        before = sorted_scatter_add.launches
        got = sorted_scatter_add(ids, upd, rows)
        torch.cuda.synchronize()
        assert sorted_scatter_add.launches == before + 1
        assert got.dtype == torch.bfloat16
        want = sorted_scatter_add_plain(ids, upd, rows)
        magnitude = sorted_scatter_add_plain(ids, upd.float().abs(), rows)
        assert _within(got, want, 1e-6 + 2.0 ** -7 * magnitude)
        rs, seg, gsum = sorted_segment_sums(ids, upd, rows)
        distinct = torch.unique(ids)
        assert gsum.dtype == torch.bfloat16
        assert _within(gsum[:distinct.numel()], want[distinct],
                       1e-6 + 2.0 ** -7 * magnitude[distinct])
    table = _bf16(rng, 2000, 512)
    ids = torch.tensor(rng.integers(0, 2000, 300), device=device)
    rows = _bf16(rng, 300, 512)
    rows = rows[torch.searchsorted(torch.unique(ids), ids)]  # equal duplicates
    want = table.clone()
    want[ids] = rows
    storage = table.data_ptr()
    rows_set(table, ids, rows)
    assert table.data_ptr() == storage and torch.equal(table, want)


@pytest.mark.cuda
@pytest.mark.parametrize("opt_type,args", [
    ("adagrad", {}), ("adam", {}), ("adamw", {"weight_decay": 0.1}),
    ("adamax", {}), ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {"momentum": 0.5, "centered": True}), ("adadelta", {}),
])
def test_bf16_fused_update_matches_plain_on_card(opt_type, args):
    """K4's bfloat16 path: table and states stay bfloat16 and agree with
    the plain version within one bfloat16 ulp (the segment sums may round
    differently; the updates share a sign so that no sum cancels)."""
    from kge_tpu_torch.ops.optim import (
        _RULES,
        fused_sorted_update,
        fused_sorted_update_plain,
    )

    device = _card()
    rng = np.random.default_rng(5)
    rows, D, n = 3000, 256, 1000
    ids = torch.tensor(rng.integers(0, rows, n), device=device)
    upd = _bf16(rng, n, D).abs()
    param = _bf16(rng, rows, D)
    states = {k: _bf16(rng, rows, D, scale=0.1).abs()
              for k in _RULES[opt_type][0](param, args)}
    ref_param = param.clone()
    ref_states = {k: v.clone() for k, v in states.items()}
    before = fused_sorted_update.launches
    fused_sorted_update(opt_type, args, ids, upd, param, states, 0.01, 3)
    torch.cuda.synchronize()
    assert fused_sorted_update.launches == before + 1
    fused_sorted_update_plain(opt_type, args, ids, upd, ref_param, ref_states,
                              0.01, 3)
    assert param.dtype == torch.bfloat16
    assert _within(param, ref_param, 2.0 ** -7 * ref_param.float().abs())
    for k in states:
        assert states[k].dtype == torch.bfloat16
        assert _within(states[k], ref_states[k],
                       2.0 ** -7 * ref_states[k].float().abs()), k


#: (n, K, F, d, pool parts as column halves of one table, sel partly
#: outside [0, F)): chip_smoke.py's POOLED_CASES at their edges
BF16_POOLED_CASES = [
    (512, 64, 8, 128, False, False),
    (512, 64, 8, 128, True, False),
    (37, 5, 3, 100, True, False), (37, 5, 3, 51, True, False),  # scalar widths
    (1024, 1024, 8, 256, False, False),  # K = 1,024
    (1000, 128, 8, 128, False, False),   # several row chunks, n no multiple of one
    (999, 64, 8, 256, True, False),
    (300, 13, 8, 300, False, False),     # K no multiple of 8, d of the tile
    (500, 64, 1, 128, False, False), (500, 40, 16, 192, True, False),  # F = 1, 16
    (200, 6, 100, 128, True, False),     # dq's pool groups too large to stage
    (300, 24, 8, 128, False, True), (300, 24, 8, 100, True, True),  # sel outside
    (0, 16, 4, 64, False, False),        # no rows
    # the forward's edges: n and K one past a block's 256 rows and 16
    # slots, d = 132; F = 24 staged for l1 and not for cmod; F = 60 from L2
    (257, 17, 8, 132, True, False), (300, 20, 24, 64, False, False),
    (150, 9, 60, 40, False, False),
]


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,F,d,stride_parts,outside", BF16_POOLED_CASES)
@pytest.mark.parametrize("kind", ["l1", "cmod"])
def test_bf16_pooled_kernels_match_plain_on_card(kind, n, K, F, d, stride_parts,
                                                 outside):
    """K5a and K5b in bfloat16 against the plain version (autograd): scores
    within one bfloat16 ulp, dq and dpool within one ulp plus 2^-12 of the
    summed factor magnitudes (float32 sums in other orders, then one
    rounding each); bit-equal across two launches. A sel outside [0, F)
    stands for a zero candidate and no pool row: the plain version runs on
    pools with a zero row appended to every group."""
    from kge_tpu_torch.ops.dist_pool import (
        pooled_dist_scores,
        pooled_dist_scores_plain,
    )

    device = _card()
    rng = np.random.default_rng(9)
    parts = 1 if kind == "l1" else 2
    qs = [_bf16(rng, n, d) for _ in range(parts)]
    if stride_parts and parts == 2:
        pools = list(torch.chunk(_bf16(rng, K * F, 2 * d), 2, dim=1))
    else:
        pools = [_bf16(rng, K * F, d) for _ in range(parts)]
    sel = torch.tensor(rng.integers(0, F, (n, K)), device=device)
    for i, j in ((0, 1), (3, K - 1)):  # distance exactly 0
        if i < n:
            for q, pool in zip(qs, pools):
                q[i] = pool[j * F + sel[i, j]]
    if outside:
        sel[torch.tensor(rng.random((n, K)) < 0.1, device=device)] = -1
        sel[torch.tensor(rng.random((n, K)) < 0.1, device=device)] = F
        sel[torch.tensor(rng.random((n, K)) < 0.05, device=device)] = F + 7
    g = _bf16(rng, n, K)

    def kernel():
        tensors = [x.clone().requires_grad_(True) for x in (*qs, *pools)]
        before = (pooled_dist_scores.bf16_launches,
                  pooled_dist_scores.bf16_backward_launches)
        out = pooled_dist_scores(tensors[:parts], tensors[parts:], sel, F, kind)
        grads = torch.autograd.grad(out, tensors, g)
        torch.cuda.synchronize()
        assert (pooled_dist_scores.bf16_launches,
                pooled_dist_scores.bf16_backward_launches) == (before[0] + (n > 0),
                                                               before[1] + 1)
        return out.detach(), list(grads)

    (out, grads), (out2, grads2) = kernel(), kernel()
    assert torch.equal(out.view(torch.int16), out2.view(torch.int16))
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(grads, grads2))
    inside = (sel >= 0) & (sel < F)
    sel_z = torch.where(inside, sel, torch.full_like(sel, F))
    zero = torch.zeros(K, 1, d, dtype=torch.bfloat16, device=device)
    tensors = [q.clone().requires_grad_(True) for q in qs] + [
        torch.cat([p.reshape(K, F, d), zero], 1).reshape(K * (F + 1), d)
        .requires_grad_(True) for p in pools]
    ref = pooled_dist_scores_plain(tensors[:parts], tensors[parts:], sel_z, F + 1, kind)
    ref_grads = list(torch.autograd.grad(ref, tensors, g))
    ref_grads[parts:] = [x.reshape(K, F + 1, d)[:, :F].reshape(K * F, d)
                         for x in ref_grads[parts:]]
    assert out.dtype == torch.bfloat16 and out.shape == (n, K)
    assert _within(out, ref, 2.0 ** -7 * ref.float().abs() + 1e-6)
    # every factor is at most 2 |g| in magnitude
    dq_mag = 2 * g.float().abs().sum(1, keepdim=True)
    rows = (torch.arange(K, device=device)[None, :] * F + sel)[inside]
    dpool_mag = torch.zeros(K * F, 1, device=device).index_add_(
        0, rows, 2 * g.float().abs()[inside].reshape(-1, 1))
    for i, (got, want) in enumerate(zip(grads, ref_grads)):
        mag = dq_mag if i < parts else dpool_mag
        assert got.dtype == torch.bfloat16
        assert _within(got, want, 2.0 ** -7 * want.float().abs()
                       + 2.0 ** -12 * mag + 1e-6), i


@pytest.mark.cuda
def test_bf16_pooled_scores_keep_the_plain_version_at_infinite_terms():
    """``cmod`` in bfloat16 with terms of +inf (a difference whose square
    overflows) and NaN: the scores the plain version gives, -inf and NaN in
    the same places (the fast square root keeps +inf, and such pairs are
    scored again with IEEE square roots), every other score within one
    bfloat16 ulp."""
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores, pooled_dist_scores_plain

    device = _card()
    rng = np.random.default_rng(10)
    n, K, F, d = 40, 20, 4, 36
    qs = [_bf16(rng, n, d) for _ in range(2)]
    pools = [_bf16(rng, K * F, d) for _ in range(2)]
    qs[0][3, 5] = 3e19         # every pair of row 3: an infinite term
    qs[1][7, 0] = float("nan")  # every pair of row 7: NaN
    pools[0][2 * F + 1, 7] = -3e19  # the pairs (i, 2) that select it
    sel = torch.tensor(rng.integers(0, F, (n, K)), device=device)
    out = pooled_dist_scores(qs, pools, sel, F, "cmod")
    plain = pooled_dist_scores_plain(qs, pools, sel, F, "cmod")
    assert bool(torch.isinf(plain).any()) and bool(torch.isnan(plain).any())
    assert torch.equal(torch.isnan(out), torch.isnan(plain))
    assert torch.equal(torch.isinf(out), torch.isinf(plain))
    assert torch.equal(out[torch.isinf(out)], plain[torch.isinf(plain)])
    finite = torch.isfinite(plain)
    assert _within(out[finite], plain[finite],
                   2.0 ** -7 * plain[finite].float().abs() + 1e-6)


def _bf16_count(low: float, high: float) -> int:
    """Non-negative bfloat16 values in [low, high] (high may be inf)."""
    bits = np.arange(0x8000, dtype=np.uint32) << 16
    values = bits.view(np.float32)
    return int(((values >= low) & (values <= high)).sum())


@pytest.mark.cuda
def test_bf16_fast_operations_are_exact_on_card():
    """The bfloat16 path's fast operations against the IEEE ones,
    exhaustively: sub/add/mul.rn.bf16x2 on all 2^32 pairs of bfloat16
    values equal the float32 operations rounded to bfloat16; the fast square
    root, rounded, equals R(sqrt(t)) for every t >= R(1e-30) the kernels can
    give it (+inf too); the fast quotient equals R(g / R(2 dist)) for every
    g of its range (0, or |g| in [2^-61, 2^77]) and every distance in
    [2^-50, 2^64] or +inf."""
    from kge_tpu_torch.ops.dist_pool import bf16_fast_ops_check

    device = _card()
    counts = bf16_fast_ops_check(device)
    torch.cuda.synchronize()
    eps = float(torch.tensor(1e-30).bfloat16())
    assert counts["sub_differ"] == counts["add_differ"] == counts["mul_differ"] == 0
    assert counts["sqrt_inputs"] == _bf16_count(eps, float("inf"))
    assert counts["sqrt_differ"] == 0
    fast_g = 2 * _bf16_count(2.0 ** -61, 2.0 ** 77) + 2  # both signs, and +-0
    distances = _bf16_count(2.0 ** -50, 2.0 ** 64) + 1  # and +inf
    assert counts["quotient_pairs"] == fast_g * distances
    assert counts["quotient_differ"] == 0


@pytest.mark.cuda
def test_f16_fast_operations_are_exact_on_card():
    """The float16 path's fast operations against the IEEE ones,
    exhaustively: sub/add/mul.rn.f16x2 on all 2^32 pairs of float16 values
    equal the float32 operations rounded to float16; the corrected square
    root equals R(sqrt(t)) for every non-negative float16 t, +inf and NaN
    included; the refined quotient of g / 2 and D / 2, rounded, equals
    R(g / D) for every float16 g and every D with its sign bit clear (2^31
    pairs, every D = R(2 dist) of the kernels among them). Equal is the same
    bits, or NaN on both sides."""
    from kge_tpu_torch.ops.dist_pool import F16_CHECK_COUNTS, f16_fast_ops_check

    counts = f16_fast_ops_check(_card())
    torch.cuda.synchronize()
    assert tuple(counts) == F16_CHECK_COUNTS
    assert counts["sqrt_inputs"] == 1 << 15
    assert counts["quotient_pairs"] == 1 << 31
    assert {k: v for k, v in counts.items() if k.endswith("_differ")} == {
        "sub_differ": 0, "add_differ": 0, "mul_differ": 0, "sqrt_differ": 0,
        "quotient_differ": 0}


@pytest.mark.cuda
def test_two_worker_grid_search_runs_its_trials_on_card(tmp_path):
    """The toy grid search (examples/toy-complex-search-grid.yaml, 4 trials)
    with ``search.num_workers: 2`` and ``--search.device_pool
    cuda:0,cuda:0``: both worker processes pin the card and run their
    trials on it, each trial's log names the card and a worker's process,
    and the parent writes every trial's search entry."""
    import os
    import pathlib
    import shutil
    import subprocess
    import sys

    import yaml

    _card()
    root = pathlib.Path(__file__).resolve().parent.parent
    shutil.copytree(root / "tests" / "data" / "dataset_test",
                    tmp_path / "data" / "dataset_test")
    folder = tmp_path / "grid"
    env = {**os.environ, "PYTHONPATH": str(root)}
    proc = subprocess.run(
        [sys.executable, "-m", "kge_tpu_torch", "start",
         str(root / "examples" / "toy-complex-search-grid.yaml"),
         "--job.device", "cuda", "--train.max_epochs", "2",
         "--search.num_workers", "2", "--search.device_pool", "cuda:0,cuda:0",
         "--folder", str(folder)],
        cwd=str(tmp_path), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-3000:]
    locks = sorted((folder / ".device_locks").iterdir())
    assert [path.read_text().split()[1] for path in locks] == ["cuda:0", "cuda:0"]
    workers = {path.read_text().split()[0] for path in locks}
    assert len(workers) == 2 and str(os.getpid()) not in workers
    trials = sorted(folder.glob("tra_*"))
    assert len(trials) == 4
    for trial in trials:
        (line,) = [l for l in (trial / "kge.log").read_text().splitlines()
                   if " runs on " in l]
        assert " runs on cuda:0 in process " in line, line
        assert line.split()[-1] in workers
        with open(trial / "config.yaml") as f:
            assert yaml.safe_load(f)["job"]["device"] == "cuda:0"
    with open(folder / "trace.yaml") as f:
        entries = [yaml.safe_load(line) for line in f]
    done = [e for e in entries if e.get("event") == "search_completed"
            and e.get("scope") == "train"]
    assert len(done) == 4 and all(0.0 < e["metric_value"] <= 1.0 for e in done)


# -- the float16 paths of K1, K2 and K3 (parallel.*_dtype: float16) ----------------


def _f16_rank_outputs_equal(got, want):
    """Counts equal, vals and pivots (float16) equal in bits."""
    return (torch.equal(got[0], want[0]) and torch.equal(got[1], want[1])
            and torch.equal(got[2].view(torch.int16), want[2].view(torch.int16))
            and torch.equal(got[3].view(torch.int16), want[3].view(torch.int16)))


@pytest.mark.cuda
@pytest.mark.parametrize("epilogue", [None, "l2"])
@pytest.mark.parametrize("D", [30, 64, 132, 201, 512])
@pytest.mark.parametrize("n", [1, 70, 256])
@pytest.mark.parametrize("scale", [1.0, 600.0], ids=["unit", "overflow"])
def test_f16_rank_kernel_counts_equal_plain_on_card(n, D, epilogue, scale):
    """K1's float16 path (tensor-core tiles, certified decisions, the
    float32 chain for the rest): counts equal the plain version's, vals
    and pivots equal in bits, across launches and plans, at D of 30 and 201
    (loads of one value) and 64, 132, 512 (8-byte loads), with the NaN and
    infinite rows of ``_inputs``; at scale 600 (both operands) many scores
    overflow float16's range to +-inf (and the L2 epilogue's products below
    -65,504 score -inf)."""
    device = _card()
    E, num_valid = 1000, 937
    q, T, row_ptr, cols, true = (x.to(device) for x in _inputs(7, n, E, D))
    q, T = (q * scale).half(), (T * scale).half()
    true = true % num_valid
    score_map = rank_kernel.NEG_SQRT_L2 if epilogue else None
    before = fused_rank_counts.launches, fused_rank_counts.f16_launches

    def run(plan=None):
        out = fused_rank_counts(q, T, None, row_ptr, cols, num_valid, ATOL,
                                RTOL, score_map=score_map, pivot_cols=true,
                                plan=plan)
        torch.cuda.synchronize()
        return out

    first = run()
    assert (fused_rank_counts.launches, fused_rank_counts.f16_launches) == (
        before[0] + 1, before[1] + 1)
    assert first[2].dtype == first[3].dtype == torch.float16
    plain = rank_kernel.fused_rank_counts_plain(
        q, T, None, row_ptr, cols, num_valid, ATOL, RTOL, score_map=score_map,
        pivot_cols=true)
    assert _f16_rank_outputs_equal(first, plain)
    for plan in (None, rank_kernel.rank_plan(n, num_valid, num_ranges=1),
                 rank_kernel.rank_plan(n, num_valid, num_ranges=3),
                 rank_kernel.rank_plan(n, num_valid, num_ranges=num_valid)):
        assert _f16_rank_outputs_equal(run(plan), first), plan
    if scale > 1 and n > 5:
        assert bool(torch.isinf(plain[3]).any())


@pytest.mark.cuda
def test_f16_scatter_and_rows_set_match_plain_on_card():
    """K2's float16 path within one float16 ulp (2^-10 relative) of each
    row's summed magnitude of the plain version (both sum in float32, in
    other orders, and round once), at the main shape (16-byte rows) and
    at D = 30 (4-byte rows); the segment sums the same; a sum past
    65,504 an infinity in both. K3 bit for bit, in place."""
    from kge_tpu_torch.ops.embedding_ops import sorted_segment_sums

    device = _card()
    rng = np.random.default_rng(13)
    for n, rows, D, scale in ((8192, 14541, 512, 1.0), (129, 237, 30, 1.0),
                              (4096, 3, 64, 4000.0)):
        ids = torch.tensor(rng.integers(0, rows, n), device=device)
        upd = (torch.tensor(rng.normal(0.0, 1.0, (n, D)), device=device)
               .abs() * scale).half()
        before = sorted_scatter_add.launches, sorted_scatter_add.f16_launches
        got = sorted_scatter_add(ids, upd, rows)
        torch.cuda.synchronize()
        assert (sorted_scatter_add.launches, sorted_scatter_add.f16_launches) == (
            before[0] + 1, before[1] + 1)
        assert got.dtype == torch.float16
        want = sorted_scatter_add_plain(ids, upd, rows)
        magnitude = sorted_scatter_add_plain(ids, upd.float().abs(), rows)
        assert torch.equal(torch.isinf(got), torch.isinf(want))
        finite = torch.isfinite(want)
        assert _within(got[finite], want[finite], 1e-6 + 2.0 ** -10 * magnitude[finite])
        if scale > 1:
            assert bool(torch.isinf(got).all())
        rs, seg, gsum = sorted_segment_sums(ids, upd, rows)
        distinct = torch.unique(ids)
        assert gsum.dtype == torch.float16
        assert torch.equal(torch.isinf(gsum[:distinct.numel()]),
                           torch.isinf(want[distinct]))
    table = torch.randn(2000, 512, device=device).half()
    ids = torch.tensor(rng.integers(0, 2000, 300), device=device)
    rows = torch.randn(300, 512, device=device).half()
    rows = rows[torch.searchsorted(torch.unique(ids), ids)]  # equal duplicates
    want = table.clone()
    want[ids] = rows
    storage = table.data_ptr()
    before = rows_set.f16_launches
    rows_set(table, ids, rows)
    assert table.data_ptr() == storage and torch.equal(table, want)
    assert rows_set.f16_launches == before + 1


def _f16(rng, *shape, scale=1.0, device="cuda"):
    return torch.tensor(rng.normal(0.0, scale, shape).astype(np.float32),
                        device=device).half()


def _same_non_finite_and_within(got, want, bound):
    """NaN, +inf and -inf in the same places; elsewhere |got - want| <=
    bound."""
    got, want = got.float(), want.float()
    for test in (torch.isnan, torch.isposinf, torch.isneginf):
        if not torch.equal(test(got), test(want)):
            return False
    finite = torch.isfinite(want)
    bound = bound.expand_as(want) if torch.is_tensor(bound) else torch.full_like(
        want, bound)
    return bool(torch.all((got[finite] - want[finite]).abs() <= bound[finite]))


@pytest.mark.cuda
@pytest.mark.parametrize("opt_type,args", [
    ("adagrad", {}), ("adagrad", {"weight_decay": 0.01}), ("adam", {}),
    ("adamw", {"weight_decay": 0.1}), ("adamax", {}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {"momentum": 0.5, "centered": True}), ("adadelta", {}),
])
@pytest.mark.parametrize("D", [256, 30])
def test_f16_fused_update_matches_plain_on_card(opt_type, args, D):
    """K4's float16 path (ROADMAP A.11b): table and states stay float16 and
    agree with the plain version within one float16 ulp (2^-10 relative,
    or the subnormal spacing 2^-24), with NaN and +-inf where the plain
    version has them (Adagrad from zero accumulator entries: eps 1e-10 is 0
    in float16, so without weight decay an untouched entry computes 0/0,
    and one whose g^2 underflows g/0; centered RMSprop where sq - avg^2 is
    0 or below);
    8-byte rows (D = 256) and 2-byte ones (D = 30); two launches from one
    state equal in bits."""
    from kge_tpu_torch.ops.optim import (
        _RULES,
        fused_sorted_update,
        fused_sorted_update_plain,
    )

    device = _card()
    rng = np.random.default_rng(15)
    rows, n = 3000, 1000
    ids = torch.tensor(rng.integers(0, rows, n), device=device)
    upd = _f16(rng, n, D).abs()
    param = _f16(rng, rows, D)
    states = {k: _f16(rng, rows, D, scale=0.1).abs()
              for k in _RULES[opt_type][0](param, args)}
    if opt_type == "adagrad":
        states["sum"][::7] = 0  # 0/0 on untouched entries with weight decay
    start = param.clone(), {k: v.clone() for k, v in states.items()}
    ref_param = param.clone()
    ref_states = {k: v.clone() for k, v in states.items()}
    before = fused_sorted_update.launches, fused_sorted_update.f16_launches
    fused_sorted_update(opt_type, args, ids, upd, param, states, 0.01, 3)
    torch.cuda.synchronize()
    assert (fused_sorted_update.launches, fused_sorted_update.f16_launches) == (
        before[0] + 1, before[1] + 1)
    fused_sorted_update_plain(opt_type, args, ids, upd, ref_param, ref_states,
                              0.01, 3)
    assert param.dtype == torch.float16
    assert _same_non_finite_and_within(
        param, ref_param, 2.0 ** -10 * ref_param.float().abs() + 2.0 ** -24)
    for k in states:
        assert states[k].dtype == torch.float16
        assert _same_non_finite_and_within(
            states[k], ref_states[k], 2.0 ** -10 * ref_states[k].float().abs() + 2.0 ** -24), k
    if opt_type == "adagrad" and not args:
        assert bool(torch.isnan(ref_param).any())
    again, again_states = start
    fused_sorted_update(opt_type, args, ids, upd, again, again_states, 0.01, 3)
    assert torch.equal(again.view(torch.int16), param.view(torch.int16))
    for k in states:
        assert torch.equal(again_states[k].view(torch.int16), states[k].view(torch.int16))


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,F,d,stride_parts,outside", BF16_POOLED_CASES)
@pytest.mark.parametrize("kind", ["l1", "cmod"])
def test_f16_pooled_kernels_match_plain_on_card(kind, n, K, F, d, stride_parts,
                                                outside):
    """K5a and K5b in float16 (ROADMAP A.11b) against the plain version
    (autograd), at the bfloat16 test's cases: scores within one float16 ulp,
    dq and dpool within one ulp plus 2^-12 of the summed factor magnitudes
    (float32 sums in other orders, then one rounding each); bit-equal across
    two launches. The pairs (0, 1) and (3, K - 1) have distance 0 (and the
    pair (5, 0), for cmod, squares that underflow): their cmod factors are
    g / 0 times the difference, so dq and the selected pool rows hold +-inf
    and NaN in the plain version's places."""
    from kge_tpu_torch.ops.dist_pool import (
        pooled_dist_scores,
        pooled_dist_scores_plain,
    )

    device = _card()
    rng = np.random.default_rng(9)
    parts = 1 if kind == "l1" else 2
    qs = [_f16(rng, n, d) for _ in range(parts)]
    if stride_parts and parts == 2:
        pools = list(torch.chunk(_f16(rng, K * F, 2 * d), 2, dim=1))
    else:
        pools = [_f16(rng, K * F, d) for _ in range(parts)]
    sel = torch.tensor(rng.integers(0, F, (n, K)), device=device)
    for i, j in ((0, 1), (3, K - 1)):  # distance exactly 0
        if i < n:
            for q, pool in zip(qs, pools):
                q[i] = pool[j * F + sel[i, j]]
    if n > 5 and parts == 2:  # |diff| = 2^-13 at 0.1875: squares below 2^-25
        for q, pool in zip(qs, pools):
            pool[sel[5, 0], :2] = 0.1875
            q[5, :2] = 0.1875 + 2.0 ** -13
    if outside:
        sel[torch.tensor(rng.random((n, K)) < 0.1, device=device)] = -1
        sel[torch.tensor(rng.random((n, K)) < 0.1, device=device)] = F
        sel[torch.tensor(rng.random((n, K)) < 0.05, device=device)] = F + 7
    g = _f16(rng, n, K)

    def kernel():
        tensors = [x.clone().requires_grad_(True) for x in (*qs, *pools)]
        before = (pooled_dist_scores.f16_launches,
                  pooled_dist_scores.f16_backward_launches)
        out = pooled_dist_scores(tensors[:parts], tensors[parts:], sel, F, kind)
        grads = torch.autograd.grad(out, tensors, g)
        torch.cuda.synchronize()
        assert (pooled_dist_scores.f16_launches,
                pooled_dist_scores.f16_backward_launches) == (before[0] + (n > 0),
                                                              before[1] + 1)
        return out.detach(), list(grads)

    (out, grads), (out2, grads2) = kernel(), kernel()
    assert torch.equal(out.view(torch.int16), out2.view(torch.int16))
    assert all(torch.equal(a.view(torch.int16), b.view(torch.int16))
               for a, b in zip(grads, grads2))
    inside = (sel >= 0) & (sel < F)
    sel_z = torch.where(inside, sel, torch.full_like(sel, F))
    zero = torch.zeros(K, 1, d, dtype=torch.float16, device=device)
    tensors = [q.clone().requires_grad_(True) for q in qs] + [
        torch.cat([p.reshape(K, F, d), zero], 1).reshape(K * (F + 1), d)
        .requires_grad_(True) for p in pools]
    ref = pooled_dist_scores_plain(tensors[:parts], tensors[parts:], sel_z, F + 1, kind)
    ref_grads = list(torch.autograd.grad(ref, tensors, g))
    ref_grads[parts:] = [x.reshape(K, F + 1, d)[:, :F].reshape(K * F, d)
                         for x in ref_grads[parts:]]
    assert out.dtype == torch.float16 and out.shape == (n, K)
    assert _same_non_finite_and_within(out, ref, 2.0 ** -10 * ref.float().abs() + 1e-6)
    if kind == "cmod" and n > 0 and bool(inside[0, 1]):
        assert not bool(torch.isfinite(ref_grads[0][0]).all())
    dq_mag = 2 * g.float().abs().sum(1, keepdim=True)
    rows = (torch.arange(K, device=device)[None, :] * F + sel)[inside]
    dpool_mag = torch.zeros(K * F, 1, device=device).index_add_(
        0, rows, 2 * g.float().abs()[inside].reshape(-1, 1))
    for i, (got, want) in enumerate(zip(grads, ref_grads)):
        mag = dq_mag if i < parts else dpool_mag
        assert got.dtype == torch.float16
        assert _same_non_finite_and_within(
            got, want, 2.0 ** -10 * want.float().abs() + 2.0 ** -12 * mag + 1e-6), i


@pytest.mark.cuda
def test_f16_pooled_scores_keep_the_plain_version_at_infinite_terms():
    """``cmod`` in float16 with terms of +inf (a difference past 256, whose
    square overflows 65,504) and NaN: the scores the plain version gives,
    -inf and NaN in the same places, every other score within one float16
    ulp."""
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores, pooled_dist_scores_plain

    device = _card()
    rng = np.random.default_rng(10)
    n, K, F, d = 40, 20, 4, 36
    qs = [_f16(rng, n, d) for _ in range(2)]
    pools = [_f16(rng, K * F, d) for _ in range(2)]
    qs[0][3, 5] = 300.0         # every pair of row 3: an infinite term
    qs[1][7, 0] = float("nan")  # every pair of row 7: NaN
    pools[0][2 * F + 1, 7] = -300.0  # the pairs (i, 2) that select it
    sel = torch.tensor(rng.integers(0, F, (n, K)), device=device)
    out = pooled_dist_scores(qs, pools, sel, F, "cmod")
    plain = pooled_dist_scores_plain(qs, pools, sel, F, "cmod")
    assert bool(torch.isinf(plain).any()) and bool(torch.isnan(plain).any())
    assert _same_non_finite_and_within(out, plain,
                                       2.0 ** -10 * plain.float().abs() + 1e-6)
