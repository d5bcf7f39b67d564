"""Tests of kge_tpu_torch that need a CUDA card. They skip where there is
none; on the card they run without jax (this file imports only the port):

    python -m pytest tests/test_torch_cuda.py -m cuda --noconftest
"""

import numpy as np
import pytest
import torch

from kge_tpu_torch.ops import rank_kernel
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
