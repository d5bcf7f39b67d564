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
                                             (2200, 3000, 64, 2990)])
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
