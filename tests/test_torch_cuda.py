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
    with pytest.raises(ValueError):  # the kernel takes no explicit pivot
        fused_rank_counts(q, T, torch.zeros(8, device=device), row_ptr, cols,
                          50, ATOL, RTOL)
    with pytest.raises(NotImplementedError):  # an epilogue without a name
        fused_rank_counts(q, T, None, row_ptr, cols, 50, ATOL, RTOL,
                          score_map=torch.sqrt, pivot_cols=true)


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


@pytest.mark.cuda
@pytest.mark.parametrize("n,K,F,d", [(64, 16, 4, 128), (37, 5, 3, 100),
                                     (9, 130, 2, 51), (200, 8, 8, 512)])
@pytest.mark.parametrize("kind", ["l1", "cmod"])
def test_pooled_kernels_match_plain_on_card(kind, n, K, F, d):
    """Scores, dq and dpool against the plain version in float64: |error| <=
    1e-6 + 1e-5 x the sum of magnitudes an element adds up; bit-equal across
    two launches; one forward and one backward launch counted per call."""
    from kge_tpu_torch.ops.dist_pool import (
        pooled_dist_scores,
        pooled_dist_scores_plain,
    )

    device = _card()
    rng = np.random.default_rng(8)
    parts = 1 if kind == "l1" else 2
    queries = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(parts)]
    pools = [rng.normal(size=(K * F, d)).astype(np.float32) for _ in range(parts)]
    sel = rng.integers(0, F, (n, K)).astype(np.int32)
    for i, j in ((0, 1), (3, K - 1)):  # distance exactly 0
        for q, pool in zip(queries, pools):
            q[i] = pool[j * F + sel[i, j]]
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
                pooled_dist_scores.backward_launches) == (before[0] + 1, before[1] + 1)
        runs.append((out.detach(), grads))
    (out, grads), (out2, grads2) = runs
    assert torch.equal(out, out2)
    assert all(torch.equal(a, b) for a, b in zip(grads, grads2))
    leaves64 = [torch.tensor(a, device=device, dtype=torch.float64,
                             requires_grad=True) for a in queries + pools]
    ref = pooled_dist_scores_plain(leaves64[:parts], leaves64[parts:], sel, F, kind)
    ref_grads = torch.autograd.grad(ref, leaves64, g.double())
    assert bool(((out.double() - ref).abs() <= 1e-6 + 1e-5 * ref.abs()).all())
    assert float(out[0, 1].abs()) <= 1.01e-15 * d
    mag_q = g.double().abs().sum(dim=1)
    rows = torch.arange(K, device=device)[None, :] * F + sel.long()
    mag_pool = torch.zeros(K * F, dtype=torch.float64, device=device).index_add_(
        0, rows.reshape(-1), g.double().abs().reshape(-1))
    for index, (got, want) in enumerate(zip(grads, ref_grads)):
        mag = mag_q if index < parts else mag_pool
        assert torch.isfinite(got).all()
        assert bool(((got.double() - want).abs() <= 1e-6 + 1e-5 * mag[:, None]).all())


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
