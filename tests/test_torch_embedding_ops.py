"""kge_tpu_torch/ops/embedding_ops.py against kge_tpu/ops/pallas_ops.py on
the CPU: the scatter-add's plain version against the Pallas kernel in
interpret mode and against the XLA scatter, the gather's gradient against
jax.grad, and the row write against kge_tpu's. Inputs come from a numpy
seed. Tolerance: sums of float32 taken in another order, so atol 1e-5 at
unit-variance updates (1e-4 with rtol 1e-5 for the hub row of 1,600
updates), as kge_tpu's own tests of the kernel allow; row writes are
exact."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu.ops import pallas_ops
from kge_tpu_torch.ops import embedding_ops
from kge_tpu_torch.ops.embedding_ops import (
    embedding_gather,
    rows_set,
    rows_set_plain,
    scatter_add_presorted,
    sorted_scatter_add,
    sorted_scatter_add_plain,
)


@pytest.fixture(autouse=True)
def _reset_modes():
    yield
    pallas_ops.set_gather_mode("xla")
    embedding_ops.set_gather_mode("torch")


@pytest.mark.parametrize(
    "E,D,B",
    [(100, 64, 257), (7, 8, 12), (600, 130, 3000), (2048, 128, 4096)],
)
def test_scatter_add_matches_pallas_and_xla(E, D, B):
    rng = np.random.default_rng(E + D + B)
    ids = rng.integers(0, E, B)
    upd = rng.normal(size=(B, D)).astype(np.float32)
    got = sorted_scatter_add(torch.tensor(ids), torch.tensor(upd), E).numpy()
    kernel = pallas_ops.sorted_scatter_add(
        jnp.asarray(ids), jnp.asarray(upd), E, interpret=True
    )
    xla = pallas_ops._xla_scatter_add(jnp.asarray(ids), jnp.asarray(upd), E)
    np.testing.assert_allclose(got, np.asarray(kernel), atol=1e-5)
    np.testing.assert_allclose(got, np.asarray(xla), atol=1e-5)


def test_scatter_add_skewed_rows():
    """A hub row that owns 80% of the updates, and rows that own none."""
    rng = np.random.default_rng(0)
    E, D, B = 50, 64, 2000
    ids = np.where(rng.random(B) < 0.8, 3, rng.integers(0, E, B))
    upd = rng.normal(size=(B, D)).astype(np.float32)
    got = sorted_scatter_add(torch.tensor(ids), torch.tensor(upd), E).numpy()
    kernel = pallas_ops.sorted_scatter_add(
        jnp.asarray(ids), jnp.asarray(upd), E, interpret=True
    )
    np.testing.assert_allclose(got, np.asarray(kernel), atol=1e-4, rtol=1e-5)


@pytest.mark.parametrize("n", [0, 1, 33])
def test_scatter_add_presorted_equals_unsorted(n):
    rng = np.random.default_rng(n)
    ids = torch.tensor(rng.integers(0, 5, n), dtype=torch.int64)
    upd = torch.tensor(rng.normal(size=(n, 6)).astype(np.float32))
    ids_sorted, order = torch.sort(ids, stable=True)
    got = scatter_add_presorted(ids_sorted, order, upd, 9)
    want = sorted_scatter_add_plain(ids, upd, 9)
    assert got.shape == (9, 6)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-6)
    assert torch.equal(sorted_scatter_add(ids.int(), upd, 9), want)


def test_scatter_add_rejects_mismatched_shapes():
    with pytest.raises(ValueError):
        sorted_scatter_add(torch.zeros(3, dtype=torch.long), torch.zeros(4, 2), 5)
    with pytest.raises(ValueError):
        scatter_add_presorted(torch.zeros(3, dtype=torch.long),
                              torch.zeros(2, dtype=torch.long),
                              torch.zeros(3, 2), 5)
    with pytest.raises(ValueError):
        embedding_ops.set_gather_mode("pallas")


@pytest.mark.parametrize("mode", ["kernel", "torch"])
@pytest.mark.parametrize("ids_shape", [(128,), (16, 8)])
def test_embedding_gather_grad_matches_jax(mode, ids_shape):
    rng = np.random.default_rng(1)
    table = rng.normal(size=(300, 64)).astype(np.float32)
    ids = rng.integers(0, 300, ids_shape)

    pallas_ops.set_gather_mode("pallas")
    jids = jnp.asarray(ids)

    def f(t):
        return jnp.sum(jnp.sin(pallas_ops.embedding_gather(t, jids)) ** 2)

    want_value = f(jnp.asarray(table))
    want_grad = jax.grad(f)(jnp.asarray(table))

    embedding_ops.set_gather_mode(mode)
    assert embedding_ops.gather_mode() == mode
    t = torch.tensor(table, requires_grad=True)
    value = torch.sum(torch.sin(embedding_gather(t, torch.tensor(ids))) ** 2)
    (grad,) = torch.autograd.grad(value, t)
    np.testing.assert_allclose(float(value), float(want_value), rtol=1e-5)
    np.testing.assert_allclose(grad.numpy(), np.asarray(want_grad),
                               atol=1e-5, rtol=1e-4)


@pytest.mark.parametrize("D", [16, 6])
def test_rows_set_matches_jax_with_duplicates(D):
    """Duplicate ids carry identical rows, so the writers of one row race
    over equal bytes and any order gives the same table. The write is in
    place: the table keeps its storage."""
    rng = np.random.default_rng(3)
    table = rng.normal(size=(50, D)).astype(np.float32)
    ids = np.array([4, 9, 9, 30, 9, 4])
    rows = rng.normal(size=(6, D)).astype(np.float32)
    rows[2] = rows[4] = rows[1]
    rows[5] = rows[0]
    want = pallas_ops.rows_set(
        jnp.asarray(table), jnp.asarray(ids), jnp.asarray(rows), interpret=True
    )
    t = torch.tensor(table)
    ptr = t.data_ptr()
    got = rows_set(t, torch.tensor(ids), torch.tensor(rows))
    assert got is t and t.data_ptr() == ptr
    assert np.array_equal(t.numpy(), np.asarray(want))
    t2 = torch.tensor(table)
    rows_set_plain(t2, torch.tensor(ids, dtype=torch.int32), torch.tensor(rows))
    assert torch.equal(t, t2)


def test_rows_set_rejects_bad_calls():
    table = torch.zeros(5, 4)
    with pytest.raises(ValueError):
        rows_set(table, torch.tensor([1, 2]), torch.zeros(3, 4))
    param = torch.nn.Parameter(torch.zeros(5, 4))
    with pytest.raises(RuntimeError):
        rows_set(param, torch.tensor([1]), torch.zeros(1, 4))
    with torch.no_grad():
        rows_set(param, torch.tensor([1]), torch.ones(1, 4))
    assert float(param.sum()) == 4.0
    # an empty write leaves the table as it is
    assert torch.equal(rows_set(table, torch.zeros(0, dtype=torch.long),
                                torch.zeros(0, 4)), torch.zeros(5, 4))


# -- segment sums and the sort's route ---------------------------------------------

SEGMENT_CASES = {
    "duplicates": lambda rng: rng.integers(0, 9, 40),
    "arange": lambda rng: np.arange(17),
    "reversed": lambda rng: np.arange(17)[::-1].copy(),
    "all_equal": lambda rng: np.full(25, 3),
    "single": lambda rng: np.array([6]),
    "empty": lambda rng: np.zeros(0, dtype=np.int64),
    "hub": lambda rng: np.where(rng.random(300) < 0.8, 2, rng.integers(0, 50, 300)),
}


@pytest.mark.parametrize("dtype", [torch.int64, torch.int32])
@pytest.mark.parametrize("case", sorted(SEGMENT_CASES))
def test_segment_sums_match_numpy_unique_and_add_at(case, dtype):
    """``segment_sums`` on CPU tensors: sorted ids, the segment number of
    every sorted position and one summed row per distinct id, against
    numpy's ``unique`` and ``add.at``; rows past the last segment are zero.
    Sums of float32 in sorted order against float64: atol 1e-5 (1e-4 for
    the hub of 240 unit-variance updates)."""
    from kge_tpu_torch.ops.embedding_ops import sorted_segment_sums
    from kge_tpu_torch.ops.optim import segment_sums

    rng = np.random.default_rng(len(case))
    ids = SEGMENT_CASES[case](rng)
    n, D, num_rows = len(ids), 6, 60
    upd = rng.normal(size=(n, D)).astype(np.float32)
    uniq, inverse = np.unique(ids, return_inverse=True)
    want = np.zeros((n, D))
    np.add.at(want, inverse, upd.astype(np.float64))
    for fn in (segment_sums, sorted_segment_sums):
        rs, seg, gsum = fn(torch.tensor(ids, dtype=dtype), torch.tensor(upd), num_rows)
        assert rs.dtype == seg.dtype == torch.int32
        assert gsum.shape == (n, D) and gsum.dtype == torch.float32
        np.testing.assert_array_equal(rs.numpy(), np.sort(ids, kind="stable"))
        np.testing.assert_array_equal(seg.numpy(), np.sort(inverse, kind="stable"))
        np.testing.assert_allclose(gsum.numpy(), want,
                                   atol=1e-4 if case == "hub" else 1e-5)
        assert not gsum.numpy()[len(uniq):].any()


@pytest.mark.parametrize("n,route", [
    (0, "kernel"), (1, "kernel"), (8192, "kernel"), (16642, "kernel"),
    (embedding_ops.SORT_LIMIT, "kernel"), (embedding_ops.SORT_LIMIT + 1, "torch"),
    (10 ** 6, "torch"),
])
def test_sort_route_goes_by_size(n, route):
    """Up to SORT_LIMIT ids (128 tiles of 16 rounds of 256 positions) the
    kernel sorts them itself; the batch shapes of the training paths (8,192;
    10,240; 16,642) lie below it, a million ids above."""
    assert embedding_ops.sort_route(n) == route
    assert embedding_ops.SORT_LIMIT == 128 * 16 * 256


def test_cpu_scatter_counts_neither_launches_nor_torch_sorts():
    before = sorted_scatter_add.launches, sorted_scatter_add.torch_sorts
    ids = torch.arange(embedding_ops.SORT_LIMIT + 5) % 7
    got = sorted_scatter_add(ids, torch.ones(ids.shape[0], 2), 7)
    assert float(got.sum()) == 2.0 * ids.shape[0]
    assert (sorted_scatter_add.launches, sorted_scatter_add.torch_sorts) == before
