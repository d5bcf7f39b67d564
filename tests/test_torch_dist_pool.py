"""The port's pooled distance scores (ops/dist_pool.py; on the CPU the plain
version) against kge_tpu's Pallas kernels (ops/dist_pool.py, which run in
interpret mode off the TPU, as tests/test_dist_pool.py runs them): values,
dq and dpool, both score kinds, d and K no multiples of 128.

Tolerance: rtol 1e-5, atol 1e-6 on scores; the gradients rtol 1e-5, atol
2e-6 x max(1, K / 16): a dq element adds up K factors of the cotangent's
size and a dpool element those of the rows that selected it, in another
order in each package, so the rounding grows with the number of terms while
the sum itself may cancel. kge_tpu pads d to 128 for its kernel; for
``cmod`` every padded complex index adds sqrt(1e-30) = 1e-15 to a score, far
below the tolerance but not bit-equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu.ops.dist_pool import pooled_dist_scores as jax_pooled_dist_scores
from kge_tpu_torch.ops.dist_pool import (
    pooled_dist_scores,
    pooled_dist_scores_plain,
)

SHAPES = [(16, 8, 4, 32), (7, 5, 3, 20), (9, 130, 2, 12), (8, 16, 8, 100)]


def _inputs(kind, n, K, F, d, seed=0):
    """numpy queries, pools, sel and cotangent; rows 0 and 3 have a query
    equal to one of their candidates (distance exactly 0)."""
    rng = np.random.default_rng(seed)
    parts = 1 if kind == "l1" else 2
    queries = [rng.normal(size=(n, d)).astype(np.float32) for _ in range(parts)]
    pools = [rng.normal(size=(K * F, d)).astype(np.float32) for _ in range(parts)]
    sel = rng.integers(0, F, size=(n, K)).astype(np.int32)
    for i, j in ((0, 1), (3, K - 1)):
        for q, pool in zip(queries, pools):
            q[i] = pool[j * F + sel[i, j]]
    w = rng.normal(size=(n, K)).astype(np.float32)
    return queries, pools, sel, w


def _jax_values_and_grads(queries, pools, sel, w, F, kind):
    parts = len(queries)

    def loss(*arrays):
        scores = jax_pooled_dist_scores(
            arrays[:parts], arrays[parts:], jnp.asarray(sel), F, kind)
        return jnp.sum(jnp.asarray(w) * scores), scores

    arrays = [jnp.asarray(a) for a in queries + pools]
    (_, scores), grads = jax.value_and_grad(
        loss, argnums=tuple(range(2 * parts)), has_aux=True)(*arrays)
    return np.asarray(scores), [np.asarray(g) for g in grads]


@pytest.mark.parametrize("n,K,F,d", SHAPES)
@pytest.mark.parametrize("kind", ["l1", "cmod"])
def test_scores_and_gradients_match_jax(kind, n, K, F, d):
    queries, pools, sel, w = _inputs(kind, n, K, F, d)
    want_scores, want_grads = _jax_values_and_grads(queries, pools, sel, w, F, kind)
    leaves = [torch.tensor(a, requires_grad=True) for a in queries + pools]
    parts = len(queries)
    scores = pooled_dist_scores(leaves[:parts], leaves[parts:], torch.tensor(sel),
                                F, kind)
    assert scores.shape == (n, K)
    np.testing.assert_allclose(scores.detach().numpy(), want_scores,
                               rtol=1e-5, atol=1e-6)
    grads = torch.autograd.grad(scores, leaves, torch.tensor(w))
    for got, want in zip(grads, want_grads):
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5,
                                   atol=2e-6 * max(1, K / 16))
    # a query equal to its candidate: distance 0, and a zero factor
    assert abs(float(scores.detach()[0, 1])) <= 1e-14 * d


@pytest.mark.parametrize("kind", ["l1", "cmod"])
def test_definition(kind):
    """Against the definition written out with loops, in float64."""
    n, K, F, d = 5, 4, 3, 6
    queries, pools, sel, _ = _inputs(kind, n, K, F, d, seed=4)
    got = pooled_dist_scores_plain(
        [torch.tensor(q) for q in queries], [torch.tensor(p) for p in pools],
        torch.tensor(sel), F, kind).numpy()
    for i in range(n):
        for j in range(K):
            row = j * F + sel[i, j]
            diffs = [q[i].astype(np.float64) - p[row] for q, p in zip(queries, pools)]
            if kind == "l1":
                want = -np.abs(diffs[0]).sum()
            else:
                want = -np.sqrt(diffs[0] ** 2 + diffs[1] ** 2 + 1e-30).sum()
            np.testing.assert_allclose(got[i, j], want, rtol=1e-6, atol=1e-6)


def test_sel_gets_no_gradient_and_int64_sel_serves():
    queries, pools, sel, w = _inputs("l1", 6, 4, 2, 8)
    q = torch.tensor(queries[0], requires_grad=True)
    pool = torch.tensor(pools[0], requires_grad=True)
    a = pooled_dist_scores([q], [pool], torch.tensor(sel), 2, "l1")
    b = pooled_dist_scores([q], [pool], torch.tensor(sel).long(), 2, "l1")
    assert torch.equal(a, b)
    dq, dpool = torch.autograd.grad(a.sum(), [q, pool])
    # dq = -sum_j sign(q - c), so dq + dpool's total is zero per column
    torch.testing.assert_close(dq.sum(0), -dpool.sum(0))
    # pool rows that no row selected get a zero gradient
    rows = np.arange(4)[None, :] * 2 + sel
    unused = np.setdiff1d(np.arange(8), rows)
    assert bool((dpool[unused] == 0).all())


def test_pool_parts_as_column_halves_of_one_table():
    """RotatE passes the (re, im) halves of the pool's embedding as views."""
    queries, pools, sel, _ = _inputs("cmod", 6, 4, 2, 8)
    table = torch.tensor(np.concatenate(pools, axis=1))
    halves = torch.chunk(table, 2, dim=1)
    assert not halves[1].is_contiguous()
    qs = [torch.tensor(q) for q in queries]
    a = pooled_dist_scores(qs, halves, torch.tensor(sel), 2, "cmod")
    b = pooled_dist_scores(qs, [torch.tensor(p) for p in pools], torch.tensor(sel),
                           2, "cmod")
    assert torch.equal(a, b)


@pytest.mark.parametrize("bad", ["arity", "kind", "pool_arity", "pool_rows",
                                 "query_rows", "pool_factor"])
def test_errors_are_kge_tpus(bad):
    q = torch.zeros(4, 8)
    pool = torch.zeros(8, 8)
    sel = torch.zeros(4, 4, dtype=torch.int32)
    calls = {
        "arity": lambda: pooled_dist_scores([q, q], [pool, pool], sel, 2, "l1"),
        "kind": lambda: pooled_dist_scores([q], [pool], sel, 2, "nope"),
        "pool_arity": lambda: pooled_dist_scores([q, q], [pool], sel, 2, "cmod"),
        "pool_rows": lambda: pooled_dist_scores([q], [pool[:7]], sel, 2, "l1"),
        "query_rows": lambda: pooled_dist_scores([q[:3]], [pool], sel, 2, "l1"),
        "pool_factor": lambda: pooled_dist_scores([q], [pool], sel, 0, "l1"),
    }
    with pytest.raises(ValueError):
        calls[bad]()
    if bad in ("arity", "kind"):
        jq, jpool = jnp.zeros((4, 8)), jnp.zeros((8, 8))
        jsel = jnp.zeros((4, 4), jnp.int32)
        with pytest.raises(ValueError):
            if bad == "arity":
                jax_pooled_dist_scores([jq, jq], [jpool, jpool], jsel, 2, "l1")
            else:
                jax_pooled_dist_scores([jq], [jpool], jsel, 2, "nope")


def test_cpu_tensors_take_the_plain_version_and_count_no_launch():
    queries, pools, sel, _ = _inputs("l1", 6, 4, 2, 8)
    before = (pooled_dist_scores.launches, pooled_dist_scores.backward_launches)
    a = pooled_dist_scores([torch.tensor(queries[0])], [torch.tensor(pools[0])],
                           torch.tensor(sel), 2, "l1")
    b = pooled_dist_scores_plain([torch.tensor(queries[0])], [torch.tensor(pools[0])],
                                 torch.tensor(sel), 2, "l1")
    assert torch.equal(a, b)
    assert before == (pooled_dist_scores.launches,
                      pooled_dist_scores.backward_launches) == (0, 0)
