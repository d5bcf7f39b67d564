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
