"""The port's fused rank counts (kge_tpu_torch/ops/rank_kernel.py) against
kge_tpu's Pallas kernel (run in interpret mode on the CPU, as
tests/test_rank_kernel.py runs it): the same inputs, made with numpy from a
seed, through both. Counts must be equal; label values agree within rtol
1e-5, atol 1e-6 (test_rank_kernel.py's tolerance: the two sides compute
the products with different matmul libraries)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from kge_tpu.ops.rank_kernel import fused_rank_counts as jax_rank_counts
from kge_tpu_torch.ops import rank_kernel
from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

ATOL, RTOL = 1e-5, 1e-4


def _labels(rng, n, E, num_valid, k_max):
    """Per-row sorted unique label columns with skewed counts: row 0 has
    none, row 1 many, the rest a few; some columns lie at or beyond
    num_valid."""
    per_row = []
    for i in range(n):
        k = 0 if i == 0 else (min(k_max, E) if i == 1 else int(rng.integers(1, 5)))
        per_row.append(np.sort(rng.choice(E + 3, size=k, replace=False)))
    row_ptr = np.concatenate([[0], np.cumsum([len(c) for c in per_row])])
    cols = np.concatenate(per_row).astype(np.int32)
    kmax = max(len(c) for c in per_row)
    padded = np.full((n, max(kmax, 1)), E + 7, dtype=np.int32)
    for i, c in enumerate(per_row):
        padded[i, : len(c)] = c
    return row_ptr.astype(np.int32), cols, padded, per_row


def _inputs(seed, n, E, D, num_valid, edge_rows):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, D)).astype(np.float32)
    T = rng.normal(size=(E, D)).astype(np.float32)
    pivot = rng.normal(size=(n,)).astype(np.float32)
    if edge_rows:
        q[2] = np.nan                      # every score NaN (read as -inf)
        pivot[3] = -np.inf                 # -inf pivot: finite scores tie
        pivot[4] = np.nan                  # NaN pivot reads as -inf
        q[5] = 0.0
        q[5, 0] = np.inf                   # scores +inf / -inf by sign of T
        pivot[5] = -np.inf                 # both -inf count as close
        q[6] = 0.0
        q[6, 0] = -np.inf
        pivot[6] = np.inf
    row_ptr, cols, padded, per_row = _labels(rng, n, E, num_valid, 40)
    return q, T, pivot, row_ptr, cols, padded, per_row


def _jax(q, T, pivot, padded, num_valid):
    g, c, vals = jax_rank_counts(
        jnp.asarray(q), jnp.asarray(T), jnp.asarray(pivot),
        jnp.asarray(padded), num_valid, ATOL, RTOL,
    )
    return np.asarray(g), np.asarray(c), np.asarray(vals)


@pytest.mark.parametrize(
    "n,E,D,num_valid,edge_rows",
    [(8, 50, 16, 50, True), (9, 300, 32, 251, True), (20, 700, 24, 700, False)],
)
def test_plain_matches_pallas_kernel(n, E, D, num_valid, edge_rows):
    q, T, pivot, row_ptr, cols, padded, per_row = _inputs(
        n + E, n, E, D, num_valid, edge_rows
    )
    jg, jc, jvals = _jax(q, T, pivot, padded, num_valid)
    g, c, vals, piv = fused_rank_counts(
        torch.from_numpy(q), torch.from_numpy(T), torch.from_numpy(pivot),
        torch.from_numpy(row_ptr), torch.from_numpy(cols), num_valid,
        ATOL, RTOL,
    )
    np.testing.assert_array_equal(g.numpy(), jg)
    np.testing.assert_array_equal(c.numpy(), jc)
    np.testing.assert_array_equal(piv.numpy(), pivot)
    expected = np.concatenate([jvals[i, : len(r)] for i, r in enumerate(per_row)])
    np.testing.assert_allclose(vals.numpy(), expected, rtol=1e-5, atol=1e-6)
    if edge_rows:
        assert c[2] == 0 and g[2] == 0  # NaN row reads as -inf: below the pivot
        assert c[3] == num_valid                 # -inf pivot: every finite score ties


def test_pivot_cols_self_tie_matches_pallas_kernel():
    """pivot_cols takes the pivot from the row's own score at that column;
    the column ties with itself, and the counts equal kge_tpu's for that
    pivot."""
    n, E, D, num_valid = 12, 200, 16, 200
    q, T, _, row_ptr, cols, padded, _ = _inputs(3, n, E, D, num_valid, False)
    true = np.random.default_rng(4).integers(0, E, size=n).astype(np.int32)
    g, c, vals, piv = fused_rank_counts(
        torch.from_numpy(q), torch.from_numpy(T), None,
        torch.from_numpy(row_ptr), torch.from_numpy(cols), num_valid,
        ATOL, RTOL, pivot_cols=torch.from_numpy(true),
    )
    scores = torch.from_numpy(q) @ torch.from_numpy(T).T
    np.testing.assert_array_equal(
        piv.numpy(), scores[torch.arange(n), torch.from_numpy(true).long()].numpy()
    )
    assert np.all(c.numpy() >= 1)
    jg, jc, _ = _jax(q, T, piv.numpy(), padded, num_valid)
    np.testing.assert_array_equal(g.numpy(), jg)
    np.testing.assert_array_equal(c.numpy(), jc)


def test_csr_helpers():
    row_ptr = torch.tensor([0, 0, 3, 4, 4], dtype=torch.int32)
    np.testing.assert_array_equal(
        rank_kernel.csr_row_ids(row_ptr).numpy(), [1, 1, 1, 2]
    )
    mask = torch.tensor([True, False, True, True])
    np.testing.assert_array_equal(
        rank_kernel.csr_row_sums(row_ptr, mask).numpy(), [0, 2, 1, 0]
    )


def test_wrapper_checks_and_cpu_path_does_not_count():
    q = torch.zeros(2, 4)
    T = torch.zeros(5, 4)
    row_ptr = torch.zeros(3, dtype=torch.int32)
    cols = torch.zeros(0, dtype=torch.int32)
    before = fused_rank_counts.launches
    fused_rank_counts(q, T, torch.zeros(2), row_ptr, cols, 5, ATOL, RTOL)
    assert fused_rank_counts.launches == before
    with pytest.raises(NotImplementedError):
        fused_rank_counts(q, T, torch.zeros(2), row_ptr, cols, 5, ATOL, RTOL,
                          score_map=torch.sqrt)
    with pytest.raises(ValueError):
        fused_rank_counts(q, torch.zeros(5, 3), torch.zeros(2), row_ptr, cols,
                          5, ATOL, RTOL)
    with pytest.raises(ValueError):
        fused_rank_counts(q, T, torch.zeros(2), row_ptr, cols, 6, ATOL, RTOL)
    with pytest.raises(ValueError):
        fused_rank_counts(q, T, None, row_ptr, cols, 5, ATOL, RTOL)
