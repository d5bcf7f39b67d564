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
from kge_tpu_torch.ops import dist_pool
from kge_tpu_torch.ops.dist_pool import (
    dpool_plan,
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


@pytest.mark.parametrize("n,K,F,d", [(5, 13, 1, 24), (33, 17, 1, 7), (12, 3, 5, 130)])
@pytest.mark.parametrize("kind", ["l1", "cmod"])
def test_forward_matches_jax_at_edges(kind, n, K, F, d):
    """The scores alone at the forward kernel's edges: K no multiple of 8
    (nor of the kernel's slot group), F = 1, d no multiple of 4 or past a
    column tile."""
    queries, pools, sel, w = _inputs(kind, n, K, F, d, seed=5)
    want_scores, _ = _jax_values_and_grads(queries, pools, sel, w, F, kind)
    got = pooled_dist_scores([torch.tensor(q) for q in queries],
                             [torch.tensor(p) for p in pools], torch.tensor(sel),
                             F, kind)
    np.testing.assert_allclose(got.numpy(), want_scores, rtol=1e-5, atol=1e-6)
    assert abs(float(got[0, 1])) <= 1.01e-15 * d


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


@pytest.mark.parametrize("n,K,F,d,parts", [
    (4096, 128, 8, 512, 2), (8192, 128, 8, 128, 1), (8192, 128, 8, 512, 1),
    (1000, 128, 8, 128, 1), (300, 13, 8, 300, 2), (500, 64, 1, 128, 1),
    (500, 40, 16, 192, 2), (0, 16, 4, 64, 1), (37, 5, 3, 51, 2),
    (256, 1024, 8, 64, 2), (4096, 1024, 8, 1024, 2), (33, 3, 100, 8, 1),
])
def test_dpool_plan_gives_every_element_one_owner(n, K, F, d, parts):
    """The dpool launch's plan: every (pool row, element) has exactly one
    owner (a unit for the rows, a tile for the columns), the chunks cover
    [0, n) in ascending order with whole stages, and the partial sums stay
    within the stated workspace."""
    plan = dpool_plan(n, K, F, d, parts)
    owners = np.zeros((K * F, d), dtype=np.int64)
    units = dist_pool.DPOOL_UNITS
    assert plan["unit_blocks"] == -(-K * plan["f_blocks"] // units)
    for u in range(plan["unit_blocks"] * units):
        j, fb = divmod(u, plan["f_blocks"])
        f0 = fb * dist_pool.DPOOL_UNIT_ROWS
        if j >= K:
            continue
        rows = np.arange(j * F + f0, j * F + min(F, f0 + dist_pool.DPOOL_UNIT_ROWS))
        for t in range(plan["tiles"]):
            owners[rows, t * plan["tile_cols"]:(t + 1) * plan["tile_cols"]] += 1
    assert (owners == 1).all()

    rows_per_chunk, chunks = plan["rows_per_chunk"], plan["chunks"]
    assert rows_per_chunk % dist_pool.DPOOL_STAGE_ROWS == 0 and chunks >= 1
    starts = [z * rows_per_chunk for z in range(chunks)]
    stops = [min(n, s + rows_per_chunk) for s in starts]
    assert starts[0] == 0 and stops[-1] == n
    assert all(a < b for a, b in zip(starts, stops)) or n == 0
    assert all(b == c for b, c in zip(stops, starts[1:]))
    assert chunks <= max(1, -(-n // dist_pool.DPOOL_STAGE_ROWS))

    partial = parts * K * F * d
    if chunks == 1:
        assert plan["workspace_floats"] == 0 and plan["counters"] == 0
    else:
        assert plan["workspace_floats"] == chunks * partial
        assert 4 * plan["workspace_floats"] <= dist_pool.DPOOL_WORKSPACE_BYTES
        # one counter per (unit block, column tile), tiles no narrower than 32
        assert plan["counters"] >= plan["unit_blocks"] * -(-d // 32)


def test_dpool_plan_fills_the_card_and_rejects_bad_sizes():
    # P-rotate's and P-transe's shapes: enough blocks from the chunks
    for n, K, F, d, parts in ((4096, 128, 8, 512, 2), (8192, 128, 8, 128, 1)):
        plan = dpool_plan(n, K, F, d, parts)
        blocks = plan["unit_blocks"] * plan["tiles"] * plan["chunks"]
        assert blocks >= dist_pool.DPOOL_BLOCKS
    # a pool whose one copy passes the workspace bound takes one chunk
    assert dpool_plan(64, 4096, 8, 1024, 2)["chunks"] == 1
    with pytest.raises(ValueError):
        dpool_plan(-1, 4, 2, 8, 1)
    with pytest.raises(ValueError):
        dpool_plan(4, 4, 0, 8, 1)
    with pytest.raises(ValueError):
        dpool_plan(4, 4, 2, 8, 3)


@pytest.mark.parametrize("n,K,F,d,parts", [
    (4096, 128, 8, 512, 2), (8192, 128, 8, 128, 1), (8192, 128, 8, 512, 1),
    (999, 64, 8, 256, 2), (1024, 1024, 8, 256, 2), (37, 5, 3, 51, 2),
])
def test_dpool_plan_serves_the_bfloat16_backward(n, K, F, d, parts):
    """The bfloat16 backward takes dpool_plan's chunks as the float32 one
    does (its vectors are 4 bfloat16, so the tiles keep their 128 columns):
    the partial sums go to a float32 workspace within DPOOL_WORKSPACE_BYTES,
    the counters start at zero, and at P-rotate's and P-transe's shapes the
    rows come in several chunks."""
    plan = dpool_plan(n, K, F, d, parts)
    ws, counters = dist_pool.dpool_scratch(plan, torch.device("cpu"))
    assert ws.dtype == torch.float32 and ws.numel() == plan["workspace_floats"]
    assert ws.numel() * ws.element_size() <= dist_pool.DPOOL_WORKSPACE_BYTES
    assert counters.dtype == torch.int32 and counters.numel() == plan["counters"]
    assert not bool(counters.any())
    if n >= 4096:
        assert plan["chunks"] > 1 and ws.numel() == plan["chunks"] * parts * K * F * d


# -- why the bfloat16 path's fast operations are exact (csrc/dist_pool.cu) ----------

#: what the bfloat16 path's approximations err by at most, relative:
#: sqrt.approx, and rcp.approx times one product, err by under 2^-22
APPROX_ERROR = 2.0 ** -22


def _bf16_values(first_bits: int, last_bits: int) -> np.ndarray:
    """The bfloat16 values of the bit patterns [first_bits, last_bits], as
    float64."""
    bits = np.arange(first_bits, last_bits + 1, dtype=np.uint32) << 16
    return bits.view(np.float32).astype(np.float64)


def _round_bf16(x: np.ndarray) -> np.ndarray:
    """Positive float64 values of bfloat16's normal range rounded to
    bfloat16 (8 significant bits), to nearest even."""
    m, e = np.frexp(x)
    return np.ldexp(np.rint(m * 256.0), e - 8)


def _rounding_gap(x: np.ndarray) -> np.ndarray:
    """The distance of positive float64 values from the nearest bfloat16
    rounding boundary (a midpoint of two neighbours), relative to them."""
    m, _ = np.frexp(x)
    s = m * 256.0
    return np.abs(s - (np.floor(s) + 0.5)) / s


def _bits_of(value: float) -> int:
    return int(torch.tensor(value).bfloat16().view(torch.int16)) & 0xFFFF


def test_bf16_square_roots_lie_off_the_rounding_boundaries():
    """In float64: for every finite bfloat16 t >= R(1e-30) (the kernels'
    square roots take t = R(s + R(1e-30)) with s >= 0), sqrt(t) lies more
    than 2^-19 (relative) from a bfloat16 rounding boundary, so an
    approximation of relative error below that (sqrt.approx's is under
    2^-22) gives the IEEE result once rounded to bfloat16. The rounding
    here is torch's (float32 sqrt, then bfloat16)."""
    t = _bf16_values(_bits_of(1e-30), 0x7F7F)
    assert len(t) == 0x7F7F - 0x0DA2 + 1 and t[0] == float(torch.tensor(1e-30).bfloat16())
    root = np.sqrt(t)
    exact = _round_bf16(root)
    torch_bf16 = torch.sqrt(torch.tensor(t, dtype=torch.float32).bfloat16())
    np.testing.assert_array_equal(exact, torch_bf16.double().numpy())
    gap = _rounding_gap(root)
    assert gap.min() > 2.0 ** -19 > 4 * APPROX_ERROR
    np.testing.assert_array_equal(_round_bf16(root * (1 - 2.0 ** -19)), exact)
    np.testing.assert_array_equal(_round_bf16(root * (1 + 2.0 ** -19)), exact)
    # the distances the backward divides by: [2^-50, 2^64]
    assert exact.min() >= 2.0 ** -50 and exact.max() <= 2.0 ** 64


def test_bf16_quotients_lie_off_the_rounding_boundaries():
    """In float64: for every pair of bfloat16 significands (g's and the
    distance's, which 2 dist keeps), the quotient lies more than 2^-17
    (relative) from a bfloat16 rounding boundary. For |g| in [2^-61, 2^77]
    and distances in [2^-50, 2^64] the quotient g / (2 dist) lies in
    [2^-126, 2^126], bfloat16's normal range, where its rounding depends on
    the significands alone; so there the reciprocal-and-product (relative
    error under 2^-22) rounds as the IEEE quotient does."""
    m = 1.0 + np.arange(128) / 128.0
    quotient = m[:, None] / m[None, :]
    exact = _round_bf16(quotient)
    want = (torch.tensor(m, dtype=torch.float32)[:, None]
            / torch.tensor(m, dtype=torch.float32)[None, :]).bfloat16()
    np.testing.assert_array_equal(exact, want.double().numpy())
    assert _rounding_gap(quotient).min() > 2.0 ** -17 > 4 * APPROX_ERROR
    np.testing.assert_array_equal(_round_bf16(quotient * (1 - 2.0 ** -17)), exact)
    np.testing.assert_array_equal(_round_bf16(quotient * (1 + 2.0 ** -17)), exact)
    assert 2.0 ** -61 / (2 * 2.0 ** 64) == 2.0 ** -126
    assert 2.0 ** 77 / (2 * 2.0 ** -50) == 2.0 ** 126


def test_bf16_double_rounding_is_innocuous():
    """In float64, on random pairs of bfloat16 values: a difference, sum or
    product rounded once to bfloat16 (what sub/add/mul.rn.bf16x2 give)
    equals the float32 operation's result rounded to bfloat16 (what the
    plain version computes), as float32's 24 bits are at least 2 x 8 + 2.
    The card test bf16_fast_ops_check takes all 2^32 pairs."""
    rng = np.random.default_rng(0)
    bits = rng.integers(0, 1 << 16, size=(2, 1 << 18)).astype(np.uint32)
    a, b = ((x << 16).view(np.float32) for x in bits)
    # finite, in [2^-60, 2^60] and at most 40 binades apart: every exact
    # result is a float64 and a normal bfloat16
    keep = np.ones(a.shape, bool)
    for x in (a, b):
        keep &= (np.abs(x) >= 2.0 ** -60) & (np.abs(x) <= 2.0 ** 60)
    a, b = a[keep], b[keep]
    exp = np.frexp(np.stack([a, b]).astype(np.float64))[1]
    a, b = a[np.abs(exp[0] - exp[1]) <= 40], b[np.abs(exp[0] - exp[1]) <= 40]
    assert len(a) > 10000
    for op in (np.subtract, np.add, np.multiply):
        exact = op(a.astype(np.float64), b.astype(np.float64))  # exact in float64
        nonzero = exact != 0
        once = np.sign(exact[nonzero]) * _round_bf16(np.abs(exact[nonzero]))
        twice = torch.tensor(op(a, b)[nonzero]).bfloat16().double().numpy()
        np.testing.assert_array_equal(once, twice)


def test_bf16_fast_ops_check_runs_only_on_a_card():
    """The exhaustive check is a CUDA kernel: asked for the CPU it raises,
    and it names its counts in the kernel's order."""
    with pytest.raises(ValueError):
        dist_pool.bf16_fast_ops_check("cpu")
    assert dist_pool.BF16_CHECK_COUNTS[-1] == "quotient_pairs"
    assert len(set(dist_pool.BF16_CHECK_COUNTS)) == 8


# -- why the float16 path's fast operations are exact (csrc/dist_pool.cu) -----------


def _f16_from_bits(bits) -> np.ndarray:
    """float16 values of the bit patterns ``bits``, as float64."""
    return np.asarray(bits, dtype=np.uint16).view(np.float16).astype(np.float64)


def _bits32(x: np.ndarray) -> np.ndarray:
    return np.asarray(x, dtype=np.float32).view(np.uint32)


def _f32(bits: np.ndarray) -> np.ndarray:
    return np.asarray(bits, dtype=np.uint32).view(np.float32)


def _sqrt_f16(t32: np.ndarray, approx: np.ndarray) -> np.ndarray:
    """csrc/dist_pool.cu ``sqrt_f16`` in numpy, from an approximation of
    sqrt(t): the midpoint m of the approximation's float16 cell, then t
    against m^2 picks the cell's lower or upper end."""
    m = (_bits32(approx) & np.uint32(0xFFFFE000)) | np.uint32(0x1000)
    mf = _f32(m)
    with np.errstate(invalid="ignore", over="ignore", under="ignore"):
        upper = t32 > mf * mf
    return _f32(np.where(upper, m + np.uint32(0x1000), m - np.uint32(0x1000)))


def _assert_same_f16(got: np.ndarray, want: np.ndarray):
    """Equal float16 bits, or NaN on both sides."""
    with np.errstate(over="ignore"):
        got16, want16 = got.astype(np.float16), want.astype(np.float16)
    both_nan = np.isnan(got16) & np.isnan(want16)
    np.testing.assert_array_equal(got16.view(np.uint16)[~both_nan],
                                  want16.view(np.uint16)[~both_nan])


def test_f16_square_root_midpoint_test_picks_the_rounded_root():
    """For every non-negative float16 t (+inf and NaN too): the midpoint test
    of ``sqrt_f16`` gives R(sqrt(t)), the square root rounded once to
    float16 (torch: float32 sqrt, then float16), from an approximation that
    errs by 2^-20 either way (sqrt.approx's error is under 2^-22) or not at
    all: R(sqrt(t)) is either end of the approximation's float16 cell. The
    midpoints' squares are exact in float32 and never equal t."""
    t = _f16_from_bits(np.arange(0, 0x7E01))  # 0 to +inf, and one NaN
    with np.errstate(invalid="ignore"):
        t32 = t.astype(np.float32)
    want = torch.sqrt(torch.tensor(t32)).half().float().numpy()
    for err in (-(2.0 ** -20), 0.0, 2.0 ** -20):
        with np.errstate(invalid="ignore"):
            approx = (np.sqrt(t) * (1 + err)).astype(np.float32)
        _assert_same_f16(_sqrt_f16(t32, approx), want)
    # the cells' midpoints beside every root: 12 significant bits, so their
    # squares are float32 values; a float16 t has at most 11, so t != m^2
    finite = np.isfinite(t) & (t > 0)
    m = _f32((_bits32(np.sqrt(t[finite])) & np.uint32(0xFFFFE000)) | np.uint32(0x1000))
    square = m.astype(np.float64) ** 2
    np.testing.assert_array_equal((m * m).astype(np.float64), square)
    assert not np.any(square == t[finite])
    # every root of t > 0 is a normal float16 value, so the cells are normal
    assert want[finite].min() >= 2.0 ** -14


def test_f16_midpoint_squares_and_products_are_exact_in_float32():
    """The squares of every float16 midpoint (a value with 12 significant
    bits) and the products of a midpoint and a float16 value D (11 bits) are
    float32 values: 24 and 23 bits. So a float16 value never equals m^2, and
    where it differs from m D it does so by at least m D's last bit, which
    gives the quotient's margin below."""
    cells = _f16_from_bits(np.arange(0x0400, 0x7C00))  # normal float16 values
    m = cells + np.ldexp(1.0, np.frexp(cells)[1] - 12)  # their cells' midpoints
    assert m[-1] == 65520.0
    np.testing.assert_array_equal(m.astype(np.float32).astype(np.float64), m)
    square = m * m
    np.testing.assert_array_equal(square.astype(np.float32).astype(np.float64), square)
    # a midpoint's significand and D's, over every pair of them
    midpoints = (2 * np.arange(2048, 4096) + 1)[None, ::2] / 2.0  # odd 12-bit values
    d = np.arange(1024, 2048, dtype=np.float64)[:, None]
    product = midpoints * d
    np.testing.assert_array_equal(product.astype(np.float32).astype(np.float64), product)


def _quotient_f16(g: np.ndarray, D: np.ndarray, err: float):
    """csrc/dist_pool.cu ``quotient_f16`` of h = g / 2 and dist = D / 2 in
    numpy float32, with the reciprocal off by ``err`` (relative; rcp.approx
    errs by under 2^-22) and each fused multiply-add as an exact float64
    product and sum rounded to float32. Returns the refined value and the
    residual dist q - h, exact in float64."""
    h, dist = (0.5 * g).astype(np.float32), (0.5 * D).astype(np.float32)
    with np.errstate(divide="ignore", invalid="ignore", over="ignore"):
        r = (1.0 / dist.astype(np.float64) * (1 + err)).astype(np.float32)
        q = h * r
        residual = dist.astype(np.float64) * q - h
        e = residual.astype(np.float32)
        refined = (e.astype(np.float64) * -r.astype(np.float64) + q).astype(np.float32)
    return np.where(np.isnan(refined), q, refined), residual


def _check_quotients(g: np.ndarray, D: np.ndarray):
    """The refined quotient of every pair, rounded to float16, is R(g / D)
    (numpy's float64 quotient rounded to float16: R(g / D) unless it lies
    within 2^-53 of a boundary, which the margin excludes); the residual is
    a float32 value; and every quotient that is not itself a float16
    rounding boundary lies at least 2^-23 (relative) from each."""
    y = g / D
    for err in (-(2.0 ** -22), 0.0, 2.0 ** -22):
        got, residual = _quotient_f16(g, D, err)
        _assert_same_f16(got, y)
        np.testing.assert_array_equal(residual.astype(np.float32), residual)
    # the margin: the boundaries beside y (midpoints of float16 cells, 65520
    # above 65504), and |g - m D|, exact in float64
    exponent = np.clip(np.frexp(y)[1] - 1, -14, 15)
    step = np.ldexp(1.0, exponent - 10)
    low = np.floor(y / step) * step  # y's cell [low, low + step)
    binade = (low == np.ldexp(1.0, exponent)) & (exponent > -14)
    below = low - np.where(binade, step / 4, step / 2)  # the cell below's midpoint
    gap = np.abs(g - (low + step / 2) * D) / ((low + step / 2) * D)
    with np.errstate(divide="ignore"):
        gap = np.where(low > 0, np.minimum(gap, np.abs(g - below * D) / (below * D)), gap)
    ties = gap == 0
    assert np.all(gap[~ties] >= 2.0 ** -23)
    return ties


def test_f16_quotients_round_as_ieee():
    """For every pair of float16 significands (g and D in [1, 2): every
    quotient of normal float16 values that rounds to a normal one scales
    to one of these), at the subnormal edge (every g below 2^-13 and D in
    [2, 4): quotients from 2^-26 to 2^-14) and at the overflow edge (g in
    [2^15, 65504], D in [0.5, 1): quotients around 65520): the refined
    quotient rounds to R(g / D). Ties (a quotient that is a boundary) occur
    only among subnormal results, where the refinement is exact and rounds
    to even."""
    sig = _f16_from_bits(np.arange(0x3C00, 0x4000))  # [1, 2)
    g, D = (a.ravel() for a in np.meshgrid(sig, sig, indexing="ij"))
    assert len(g) == 1 << 20
    assert not _check_quotients(g, D).any()
    small = _f16_from_bits(np.arange(1, 0x0800))
    g, D = (a.ravel() for a in np.meshgrid(small, 2 * sig, indexing="ij"))
    ties = _check_quotients(g, D)
    assert ties.any() and np.all(np.abs(g / D)[ties] < 2.0 ** -14)
    big = _f16_from_bits(np.arange(0x7800, 0x7C00))
    half = _f16_from_bits(np.arange(0x3800, 0x3C00))
    g, D = (a.ravel() for a in np.meshgrid(big, half, indexing="ij"))
    y = g / D
    assert (y > 65520).any() and (y < 65520).any()
    assert not _check_quotients(g, D).any()


def test_f16_quotient_special_cases_are_ieee():
    """Where D is 0, +inf or NaN, or g is +-inf, NaN or +-0, the refinement
    is NaN or exact and the quotient is IEEE's: g / 0 = +-inf, 0 / 0 = NaN,
    g / inf = +-0 and +-0 / D = +-0 (signs kept), inf / inf = NaN."""
    specials = np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 2.0 ** -24, -(2.0 ** -24),
                         1.5, -3.0, 65504.0, -65504.0])
    D = np.array([0.0, np.inf, np.nan, 2.0 ** -11, 512.0, 2.0 ** -24, 1.0])
    g, D = (a.ravel() for a in np.meshgrid(specials, D, indexing="ij"))
    with np.errstate(divide="ignore", invalid="ignore"):
        want = g / D
    got, _ = _quotient_f16(g, D, 0.0)
    _assert_same_f16(got, want)


def test_f16_double_rounding_is_innocuous():
    """In float64, on random pairs of float16 values: a difference, sum or
    product rounded once to float16 (what sub/add/mul.rn.f16x2 give, with
    subnormals kept) equals the float32 operation's result rounded to
    float16 (what the plain version computes), as float32's 24 bits are at
    least 2 x 11 + 2. The card test f16_fast_ops_check takes all 2^32
    pairs."""
    rng = np.random.default_rng(0)
    a, b = (_f16_from_bits(x) for x in rng.integers(0, 0x7C00, size=(2, 1 << 18)))
    signs = rng.choice([-1.0, 1.0], size=(2, 1 << 18))
    a, b = a * signs[0], b * signs[1]
    for op in (np.subtract, np.add, np.multiply):
        exact = op(a, b)  # exact in float64: float16 values span 40 bits
        twice = torch.tensor(op(a.astype(np.float32), b.astype(np.float32))).half()
        _assert_same_f16(twice.float().numpy(), exact)


def test_f16_fast_ops_check_runs_only_on_a_card():
    """The float16 exhaustive check is a CUDA kernel too: asked for the CPU
    it raises, and it names its counts in the kernel's order."""
    with pytest.raises(ValueError):
        dist_pool.f16_fast_ops_check("cpu")
    assert dist_pool.F16_CHECK_COUNTS[-1] == "quotient_pairs"
    assert len(set(dist_pool.F16_CHECK_COUNTS)) == 7
