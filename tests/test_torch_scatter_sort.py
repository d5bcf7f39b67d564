"""The scatter kernel's sort (kge_tpu_torch/csrc/scatter_add_sorted.cu,
launch A) on the CPU: its cut (``sort_plan``) and the plain PyTorch model of
the blocked radix sort it runs (``blocked_sort_plain``: per-tile stable
ranks, digit-major counts, scanned offsets) against numpy's stable argsort,
on drawn ids: skewed, outside the table, n = 0 and 1, n at and around a
tile's range, keys of 8, 14 and 18 bits. Then K2's bfloat16 path on CPU
tensors (``sorted_scatter_add``, ``sorted_segment_sums``) against
kge_tpu's ``pallas_ops.sorted_scatter_add`` in interpret mode at odd D and
at n not a multiple of a tile. Sorts are exact; the bfloat16 sums within
two bfloat16 ulps of each entry's summed magnitude (two float32 sums of the
same bfloat16 terms in other orders, each rounded once)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from kge_tpu.ops import pallas_ops
from kge_tpu_torch.ops import embedding_ops
from kge_tpu_torch.ops.embedding_ops import (
    SORT_THREADS,
    blocked_sort_plain,
    sort_plan,
    sorted_scatter_add,
    sorted_segment_sums,
)


def _stable(ids, num_rows):
    keys = np.where((ids < 0) | (ids >= num_rows), num_rows, ids)
    order = np.argsort(keys, kind="stable")
    return keys[order], order


def _check_sort(ids, num_rows):
    keys, order = blocked_sort_plain(torch.tensor(ids, dtype=torch.int64), num_rows)
    want_keys, want_order = _stable(np.asarray(ids, np.int64), num_rows)
    assert keys.dtype == order.dtype == torch.int32
    np.testing.assert_array_equal(order.numpy(), want_order)
    np.testing.assert_array_equal(keys.numpy(), want_keys)


@pytest.mark.parametrize("n,num_rows,plan", [
    (8192, 14541, (32, 1, 2, 7)),     # the main shape: two passes of 7 bits
    (16642, 200000, (66, 1, 3, 6)),   # T-sparse's segment sums: three of 6
    (8192, 237, (32, 1, 1, 8)),       # relation lookups: one pass
    (129, 14541, (1, 1, 2, 7)),       # shared targets: one tile
    (0, 5, (1, 1, 1, 3)),
    (32769, 14541, (65, 2, 2, 7)),    # two rounds a tile above 128 x 256
    (embedding_ops.SORT_LIMIT, 200000, (128, 16, 3, 6)),
])
def test_sort_plan_cuts(n, num_rows, plan):
    """Tiles of rounds x 256 positions, at most 128 of them; the keys' bits
    in the fewest passes of at most 8 bits, shared evenly."""
    got = sort_plan(n, num_rows)
    assert (got["tiles"], got["rounds"], got["passes"], got["digit_bits"]) == plan
    assert got["passes"] * got["digit_bits"] >= max(1, num_rows.bit_length())
    assert got["tiles"] <= embedding_ops.MAX_TILES
    assert got["rounds"] <= embedding_ops.MAX_ROUNDS
    assert (got["tiles"] - 1) * got["rounds"] * SORT_THREADS < max(n, 1)


@pytest.mark.parametrize("num_rows", [14541, 200000])
@pytest.mark.parametrize("n", [0, 1, 255, 256, 257, 511, 513, 32768, 32769])
def test_blocked_sort_at_tile_edges(n, num_rows):
    """Every tile edge, a last tile of one position, two rounds a tile;
    power-law ids with a share outside the table."""
    rng = np.random.default_rng(n)
    w = 1.0 / np.arange(1, num_rows + 1) ** 0.8
    ids = rng.choice(num_rows, n, p=rng.permutation(w / w.sum()))
    ids[rng.random(n) < 0.05] = -3
    ids[rng.random(n) < 0.05] = num_rows + 9
    _check_sort(ids, num_rows)


@st.composite
def _ids(draw):
    num_rows = draw(st.sampled_from([1, 2, 237, 14541, 200000]))
    n = draw(st.one_of(st.integers(0, 600),
                       st.sampled_from([255, 256, 257, 1023, 1024, 1025])))
    kind = draw(st.sampled_from(["uniform", "hub", "outside", "arange", "equal"]))
    seed = draw(st.integers(0, 2 ** 32 - 1))
    rng = np.random.default_rng(seed)
    if kind == "uniform":
        ids = rng.integers(0, num_rows, n)
    elif kind == "hub":  # one id owns most of the batch
        ids = np.where(rng.random(n) < 0.8, num_rows // 2, rng.integers(0, num_rows, n))
    elif kind == "outside":
        ids = rng.integers(-50, num_rows + 50, n)
    elif kind == "arange":
        ids = (np.arange(n) * 7919 + seed) % num_rows
    else:
        ids = np.full(n, num_rows - 1)
    return ids.astype(np.int64), num_rows


@settings(max_examples=60, deadline=None, database=None)
@given(_ids())
def test_blocked_sort_equals_stable_argsort(case):
    ids, num_rows = case
    _check_sort(ids, num_rows)


def _bf16(rng, n, d):
    values = rng.normal(size=(n, d)).astype(np.float32)
    t = torch.tensor(values).bfloat16()
    return t.float().numpy(), t, jnp.asarray(t.float().numpy()).astype(jnp.bfloat16)


@pytest.mark.parametrize("n,rows,d", [(257, 40, 7), (513, 97, 33), (1000, 300, 130)])
def test_bf16_scatter_matches_pallas_at_odd_widths(n, rows, d):
    """K2's bfloat16 path on the CPU against kge_tpu's kernel in interpret
    mode, and the segment sums against the same rows."""
    rng = np.random.default_rng(n + d)
    ids = rng.integers(0, rows, n)
    upd, upd_t, upd_j = _bf16(rng, n, d)
    want = np.asarray(pallas_ops.sorted_scatter_add(
        jnp.asarray(ids), upd_j, rows, interpret=True), np.float32)
    magnitude = np.zeros((rows, d), np.float32)
    np.add.at(magnitude, ids, np.abs(upd))
    bound = 1e-6 + 2 * 2.0 ** -8 * magnitude
    got = sorted_scatter_add(torch.tensor(ids), upd_t, rows)
    assert got.dtype == torch.bfloat16
    assert np.all(np.abs(got.float().numpy() - want) <= bound)
    rs, seg, gsum = sorted_segment_sums(torch.tensor(ids, dtype=torch.int32), upd_t, rows)
    distinct = np.unique(ids)
    np.testing.assert_array_equal(rs.numpy(), np.sort(ids))
    assert gsum.dtype == torch.bfloat16
    assert np.all(np.abs(gsum[:len(distinct)].float().numpy() - want[distinct])
                  <= bound[distinct])
    assert not gsum[len(distinct):].float().numpy().any()
