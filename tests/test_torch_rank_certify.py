"""The certificate of the rank kernel's bfloat16 and float16 paths, in
plain PyTorch.

The kernel (csrc/rank_counts.cu) multiplies its tiles on the tensor cores
and keeps the decisions of the float32 chain: where RD(x - E) and RU(x + E)
around a tensor-core sum x fall in one category (below, close, greater),
the chain does too, and the rest is recomputed by the chain. These tests
hold ``certified_categories`` (the rule, as the kernel's epilogue applies
it) to the chain's categories under ``close_greater``, its directed
roundings to exact rational arithmetic, the monotonicity that the rule
rests on, and the chain's error to its part of gamma_D. The kernel's own
sums are checked against the rule on the card (tests/test_torch_cuda.py,
chip_smoke.py phase 22). The float16 tests take the bfloat16 ones' data
where float16 can hold them, and add scores that overflow float16's range,
rows of subnormal values and the edges of the tolerance at an atol below
2^-14 (a float16 subnormal).
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from kge_tpu_torch.ops import rank_kernel
from kge_tpu_torch.ops.rank_kernel import (
    NEG_SQRT_L2,
    certificate_bound,
    certificate_eta,
    certificate_gamma,
    certified_categories,
    chain_error_factor,
    chain_scores,
    chain_sums,
    close_greater,
)
from kge_tpu_torch.utils.dtypes import weak

ATOL, RTOL = 1e-5, 1e-4  # entity_ranking.tie_handling defaults


def _bf16(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32)).bfloat16()


def _f16(a) -> torch.Tensor:
    return torch.tensor(np.asarray(a, dtype=np.float32)).half()


def _categories(scores: torch.Tensor, pivot: torch.Tensor, score_map=None):
    """0 below, 1 close, 2 greater: the plain version's decisions."""
    if score_map is not None:
        scores = score_map(scores)
    close, greater = close_greater(scores, pivot[:, None], ATOL, RTOL)
    return close.to(torch.int8) + 2 * greater.to(torch.int8)


def _toward(c: torch.Tensor, x64: torch.Tensor) -> torch.Tensor:
    """x64 rounded to float32 toward c, so that |x - c| <= |x64 - c|."""
    up = rank_kernel._round_f32(x64, torch.zeros_like(x64), up=True)
    down = rank_kernel._round_f32(x64, torch.zeros_like(x64), up=False)
    return torch.where(x64 < c.double(), up, down)


def _sums_within(c: torch.Tensor, bound: torch.Tensor, rng) -> list:
    """Float32 sums x with |x - c| <= bound (exactly): the interval's ends,
    their float32 neighbours inside it, random points, and c itself."""
    c64, b64 = c.double(), bound.double()
    lo = _toward(c, c64 - b64)
    hi = _toward(c, c64 + b64)
    inside_lo = torch.where(lo < c, torch.nextafter(lo, c), lo)
    inside_hi = torch.where(hi > c, torch.nextafter(hi, c), hi)
    u = torch.tensor(rng.uniform(-1.0, 1.0, c.shape))
    return [c, lo, hi, inside_lo, inside_hi, _toward(c, c64 + u * b64)]


def _exact_norm_bounds(x: torch.Tensor) -> torch.Tensor:
    """Float32 upper bounds of the rows' 2-norms, from float64."""
    norm = x.double().pow(2).sum(1).sqrt()
    return rank_kernel._round_f32(norm * (1 + 2.0 ** -40), torch.zeros_like(norm),
                                  up=True)


def _data(kind: str, seed: int, dtype=torch.bfloat16):
    """(q, t, pivot_cols, score_map) in bfloat16 (or float16) for one data
    kind. In float16 ``wide_exponents`` spreads over 2^-20..2^10 (no
    overflow, many subnormals); ``overflow`` puts a fifth of the scores past
    65,520 in magnitude (an infinity in float16, the pivots' among them);
    ``subnormals`` holds values below 2^-14 in every row."""
    rng = np.random.default_rng(seed)
    f16 = dtype == torch.float16
    n, m, D = 24, 160, 64
    score_map = None
    if kind == "gaussian":
        q, t = rng.normal(0, 0.2, (n, D)), rng.normal(0, 0.2, (m, D))
    elif kind == "cancellation":
        # large products that cancel: each row's sum is small against S
        base = rng.normal(0, 1.0, (n, D))
        q = np.repeat(np.abs(base[:, :1]), D, axis=1) * 4.0 + base * 1e-2
        sign = np.where(np.arange(D) % 2 == 0, 1.0, -1.0)
        t = sign * rng.uniform(0.5, 2.0, (m, 1)) + rng.normal(0, 1e-2, (m, D))
    elif kind == "ties":
        q = rng.normal(0, 0.3, (n, D))
        t = rng.normal(0, 0.3, (m, D))
        t[m // 2:] = t[0]                    # duplicated candidate rows
        t[1:m // 2:3, 0] += rng.normal(0, 0.01, len(range(1, m // 2, 3)))
    elif kind == "zero_rows":
        # pivots in the atol region: zero queries and tiny candidates (in
        # float16, scores of the order of atol)
        q = rng.normal(0, 0.2, (n, D))
        q[::2] = 0.0
        t = rng.normal(0, 1e-4, (m, D))
        if f16:
            t *= 0.2
    elif kind == "nonfinite":
        q, t = rng.normal(0, 0.2, (n, D)), rng.normal(0, 0.2, (m, D))
        q[1, 3], q[2, 0], q[3, 5] = np.inf, -np.inf, np.nan
        t[4, 2], t[7, 1], t[9, 9] = np.inf, np.nan, -np.inf
    elif kind == "wide_exponents":
        low, high = (-20, 10) if f16 else (-30, 30)
        q = rng.normal(0, 1, (n, D)) * 2.0 ** rng.integers(low, high, (n, D))
        t = rng.normal(0, 1, (m, D)) * 2.0 ** rng.integers(low, high, (m, D))
    elif kind == "overflow":
        q, t = rng.normal(0, 80, (n, D)), rng.normal(0, 80, (m, D))
    elif kind == "subnormals":
        q, t = rng.normal(0, 0.3, (n, D)), rng.normal(0, 0.3, (m, D))
        q[::3] *= 2.0 ** -14
        t[::4] *= 2.0 ** -14
        q[:, ::5] *= 2.0 ** -13
        t[:, ::6] *= 2.0 ** -13
    elif kind == "l2":
        from kge_tpu_torch.models.translation import _l2_factorization

        h = rng.normal(0, 0.1, (n, D - 4)).astype(np.float32)
        c = rng.normal(0, 0.1, (m, D - 4)).astype(np.float32)
        c[:n:2] = h[::2] + rng.normal(0, 1e-3, h[::2].shape)  # close pairs
        query, target_map, score_map = _l2_factorization(torch.tensor(h))
        q = query.numpy()
        t = target_map(torch.tensor(c)).numpy()
    else:
        raise ValueError(kind)
    pivot_cols = torch.tensor(rng.integers(0, m, n), dtype=torch.int64)
    if kind == "ties":
        pivot_cols[: n // 2] = 0              # the true row repeated
    if kind == "l2":
        pivot_cols[: n // 2] = torch.arange(0, n, 2)
    to = _f16 if f16 else _bf16
    return to(q), to(t), pivot_cols, score_map


KINDS = ["gaussian", "cancellation", "ties", "zero_rows", "nonfinite",
         "wide_exponents", "l2"]
F16_KINDS = KINDS + ["overflow", "subnormals"]


@pytest.mark.parametrize("scale", [1.0, 1e3])
@pytest.mark.parametrize("kind", KINDS)
def test_certified_categories_are_the_chains(kind, scale):
    """Test 1: for sums anywhere within E of the chain's float32 sum (the
    interval's ends, the float32 values just inside them, random points),
    every entry the rule decides has the category of ``chain_scores``
    under ``close_greater``; at the kernel's bound the rule decides most
    entries of finite rows, and never one of a row whose pivot is not
    finite."""
    _check_categories_are_the_chains(kind, scale, torch.bfloat16)


@pytest.mark.parametrize("scale", [1.0, 1e3])
@pytest.mark.parametrize("kind", F16_KINDS)
def test_f16_certified_categories_are_the_chains(kind, scale):
    """Test 1 in float16, scores past float16's range (infinite pivots
    among them) and subnormal rows included."""
    q, t, _, _ = _data(kind, seed=len(kind), dtype=torch.float16)
    if kind == "overflow":
        assert bool(torch.isinf(chain_scores(q, t)).float().mean() > 0.1)
    if kind == "subnormals":
        tiny = (q != 0) & (q.abs() < 2.0 ** -14)
        assert bool(tiny.any(1).all())
    _check_categories_are_the_chains(kind, scale, torch.float16)


def _check_categories_are_the_chains(kind, scale, dtype):
    q, t, pivot_cols, score_map = _data(kind, seed=len(kind), dtype=dtype)
    D = q.shape[1]
    c = chain_sums(q, t)
    scores = chain_scores(q, t)
    mapped = scores if score_map is None else score_map(scores)
    pivot = mapped.gather(1, pivot_cols[:, None])[:, 0]
    want = _categories(scores, pivot, score_map)
    bound = certificate_bound(_exact_norm_bounds(q), _exact_norm_bounds(t), D)
    # scale 1e3 widens the interval a thousandfold: more entries at a boundary
    bound = torch.where(torch.isfinite(bound),
                        (bound.double() * scale).float(), bound)
    rng = np.random.default_rng(7)
    finite_rows = torch.isfinite(pivot)[:, None].expand_as(c)
    decided_total = 0
    for x in _sums_within(c, bound, rng):
        got = certified_categories(x, bound, pivot, ATOL, RTOL, score_map)
        decided = got >= 0
        assert torch.equal(got[decided], want[decided]), kind
        assert not bool(decided[~finite_rows].any())
        decided_total += int(decided.sum())
    # not vacuous: at the kernel's own bound most finite entries are settled
    if scale == 1.0:
        assert decided_total >= 0.5 * 6 * int((finite_rows & torch.isfinite(c)).sum())


@pytest.mark.parametrize("score_map", [None, NEG_SQRT_L2])
@pytest.mark.parametrize("pivot_value", [0.05, 1.0, -3.0, 0.0, 3e-6, -1e-6,
                                         1e30, -0.25])
def test_rule_at_the_rounding_edges(pivot_value, score_map):
    """Test 1 at the places where a category changes: sums swept over
    consecutive float32 values around the bfloat16 midpoints next to the
    pivot (where the rounding to bfloat16 flips) and around 0 (the L2
    epilogue's clamp), with bounds of 0 to 64 float32 ulps: decided entries
    are always the sum's own category, and the category is non-decreasing
    along each sweep (the monotonicity the rule rests on)."""
    _check_rule_at_the_rounding_edges(pivot_value, score_map, torch.bfloat16)


@pytest.mark.parametrize("score_map", [None, NEG_SQRT_L2])
@pytest.mark.parametrize("pivot_value", [0.05, 1.0, -3.0, 0.0, 3e-6, -1e-6,
                                         6e-5, -0.25, 200.0, 60000.0, -65504.0])
def test_f16_rule_at_the_rounding_edges(pivot_value, score_map):
    """Test 1 in float16 at the float16 midpoints next to the pivot, around
    0, at the edges of the tolerance P +- tol (with atol 1e-5 a float16
    subnormal: the pivots 0, 3e-6 and -1e-6 put those edges among the
    subnormals) and at +-65,520, where the rounding to float16 overflows to
    an infinity (the largest finite pivot, -65,504, meets it)."""
    _check_rule_at_the_rounding_edges(pivot_value, score_map, torch.float16)


def _check_rule_at_the_rounding_edges(pivot_value, score_map, dtype):
    f16 = dtype == torch.float16
    p = torch.tensor([pivot_value], dtype=torch.float32).to(dtype)
    if score_map is not None:
        p = score_map(p)
    centres = [0.0]
    preimages = [p.float(), -p.float() ** 2]  # the identity's and L2's
    if f16:
        tol = weak(ATOL, p) + weak(RTOL, p) * p.abs()
        preimages += [(p + tol).float(), (p - tol).float()]
        centres += [65520.0, -65520.0]
    for s in preimages:
        v = s.to(dtype)
        for step in range(-3, 4):
            nb = v
            for _ in range(abs(step)):
                nb = torch.nextafter(nb, torch.full_like(nb, float(np.sign(step))))
            if torch.isfinite(nb).all():
                # the float32 midpoint between two bfloat16 neighbours
                nxt = torch.nextafter(nb, torch.full_like(nb, float("inf")))
                centre = float((nb.double() + nxt.double()) / 2)
                if np.isfinite(centre) and abs(centre) < 2.0 ** 127:
                    centres.append(centre)
    sweeps = []
    for centre in centres:
        mid = torch.tensor([centre], dtype=torch.float32)
        below, above = [mid], [mid]
        for _ in range(300):
            below.append(torch.nextafter(below[-1], torch.tensor([-np.inf])))
            above.append(torch.nextafter(above[-1], torch.tensor([np.inf])))
        sweeps.append(torch.cat(below[::-1] + above[1:]))
    c = torch.cat(sweeps)[None, :]
    pivot = p.reshape(1)
    want = _categories(c.to(dtype), pivot, score_map)
    for sweep in want[0].split(601):
        assert bool((sweep[1:] >= sweep[:-1]).all()), "category not monotone"
    rng = np.random.default_rng(3)
    for ulps in (0, 1, 7, 64):
        bound = (c.abs() * (ulps * 2.0 ** -23)).float()
        for x in _sums_within(c, bound, rng):
            got = certified_categories(x, bound, pivot, ATOL, RTOL, score_map)
            decided = got >= 0
            assert torch.equal(got[decided], want[decided])
            if ulps == 0:
                assert bool(decided.all()) or not bool(torch.isfinite(pivot).all())


def _exact(v) -> Fraction:
    return Fraction(float(v))


@pytest.mark.parametrize("regime", ["near", "far", "huge", "tiny"])
def test_directed_roundings_are_exact(regime):
    """RD(x - e), RU(x + e), RU(N M) and RU(gamma NM + eta) as the kernel's
    __fsub_rd, __fadd_ru, __fmul_ru and __fmaf_ru give them: the float32
    neighbours of the exact rational results, on the right side."""
    rng = np.random.default_rng({"near": 1, "far": 2, "huge": 3, "tiny": 4}[regime])
    k = 400
    x = rng.normal(0, 1, k) * 2.0 ** rng.integers(-10, 10, k)
    e = np.abs(rng.normal(0, 1, k)) * {
        "near": 2.0 ** rng.integers(-12, 2, k), "far": 2.0 ** rng.integers(-60, -30, k),
        "huge": 2.0 ** rng.integers(60, 120, k), "tiny": 2.0 ** -140 * np.ones(k)}[regime]
    x = torch.tensor(x, dtype=torch.float32)
    e = torch.tensor(e, dtype=torch.float32)
    lo = rank_kernel._round_f32(*rank_kernel._two_sum(x.double(), -e.double()), up=False)
    hi = rank_kernel._round_f32(*rank_kernel._two_sum(x.double(), e.double()), up=True)
    for xi, ei, l, h in zip(x, e, lo, hi):
        exact_lo, exact_hi = _exact(xi) - _exact(ei), _exact(xi) + _exact(ei)
        assert _exact(l) <= exact_lo < _exact(torch.nextafter(l, torch.tensor(np.inf)))
        assert _exact(torch.nextafter(h, torch.tensor(-np.inf))) < exact_hi <= _exact(h)
    nq = torch.tensor(np.abs(rng.normal(0, 1, 12)) * 2.0 ** rng.integers(-20, 20, 12),
                      dtype=torch.float32)
    nt = torch.tensor(np.abs(rng.normal(0, 1, 9)) * 2.0 ** rng.integers(-20, 20, 9),
                      dtype=torch.float32)
    for D in (30, 132, 512):
        E = certificate_bound(nq, nt, D)
        for i in range(len(nq)):
            for j in range(len(nt)):
                nm = _exact(nq[i]) * _exact(nt[j])
                nm_ru = rank_kernel._round_f32(
                    torch.tensor([float(nm)], dtype=torch.float64),
                    torch.tensor([float(nm - Fraction(float(nm)))], dtype=torch.float64),
                    up=True)[0]
                assert _exact(nm_ru) >= nm
                want = _exact(nm_ru) * Fraction(certificate_gamma(D)) \
                    + Fraction(certificate_eta(D))
                got = E[i, j]
                assert _exact(got) >= want
                assert _exact(torch.nextafter(got, torch.tensor(-np.inf))) < want


def test_bound_is_infinite_where_the_norms_are():
    """An infinite or NaN norm bound (an infinity, a NaN or a subnormal in
    the row) and a product past 2^126 leave every entry undecided."""
    nq = torch.tensor([1.0, float("inf"), float("nan"), 2.0 ** 100], dtype=torch.float32)
    nt = torch.tensor([1.0, 0.0, 2.0 ** 30], dtype=torch.float32)
    E = certificate_bound(nq, nt, 64)
    assert bool(torch.isfinite(E[0]).all())
    assert not bool(torch.isfinite(E[1:3]).any())
    assert not bool(torch.isfinite(E[3, 2]))  # 2^130
    x = torch.zeros(4, 3)
    pivot = torch.zeros(4, dtype=torch.bfloat16)
    got = certified_categories(x, E, pivot, ATOL, RTOL)
    assert bool((got[1:3] == -1).all()) and int(got[3, 2]) == -1
    # a zero sum of zero norms against a zero pivot is close; where the
    # bound reaches past the tolerance the entry stays open
    assert got[0].tolist() == [-1, 1, -1]


@pytest.mark.parametrize("D", [16, 132, 201, 512])
@pytest.mark.parametrize("kind", ["alternating", "wide", "positive"])
def test_chain_error_within_its_part_of_gamma(kind, D):
    """Test 2: the chain's error against a float64 sum stays within
    chain_error_factor(D) S on adversarial cancellation data, and that part
    with the tensor cores' modelled 6 D16 u S (1 + 8 D16 u) fits in
    gamma_D."""
    _check_chain_error(kind, D, torch.bfloat16)


@pytest.mark.parametrize("D", [16, 132, 201, 512])
@pytest.mark.parametrize("kind", ["alternating", "wide", "positive"])
def test_f16_chain_error_within_its_part_of_gamma(kind, D):
    """Test 2 in float16 (``wide`` over 2^-24..2^10: subnormal operands and
    products down to 2^-48, which float32 holds exactly)."""
    _check_chain_error(kind, D, torch.float16)


def _check_chain_error(kind, D, dtype):
    f16 = dtype == torch.float16
    rng = np.random.default_rng(D)
    n, m = 16, 48
    if kind == "alternating":
        # big alternating products and a small residual: x << S
        q = rng.uniform(1.0, 2.0, (n, D)) * 2.0 ** 10
        t = np.where(np.arange(D) % 2 == 0, 1.0, -1.0) * rng.uniform(1.0, 1.01, (m, D))
        t[:, -1] *= 1e-3
    elif kind == "wide":
        low, high = (-24, 10) if f16 else (-40, 40)
        q = rng.normal(0, 1, (n, D)) * 2.0 ** rng.integers(low, high, (n, D))
        t = rng.normal(0, 1, (m, D)) * 2.0 ** rng.integers(low, high, (m, D))
    else:  # every product positive: rounding errors do not cancel either
        q = rng.uniform(0.5, 1.0, (n, D)) * 2.0 ** rng.integers(-8, 8, (n, D))
        t = rng.uniform(0.5, 1.0, (m, D)) * 2.0 ** rng.integers(-8, 8, (m, D))
    q, t = (_f16(q), _f16(t)) if f16 else (_bf16(q), _bf16(t))
    c = chain_sums(q, t).double()
    exact = q.double() @ t.double().T  # exact products, float64 sums
    S = q.double().abs() @ t.double().abs().T
    err = (c - exact).abs()
    # float64's own error of the reference, at most D 2^-53 S
    assert bool((err <= chain_error_factor(D) * S + D * 2.0 ** -52 * S).all())
    assert float((err / S).max()) > 0.0  # the data do make the chain round
    d16 = 16 * -(-D // 16)
    u = 2.0 ** -24
    assert chain_error_factor(D) + 6 * d16 * u * (1 + 8 * d16 * u) <= certificate_gamma(D)


@pytest.mark.parametrize("kind", KINDS)
def test_certified_counts_with_the_recount_equal_plain(kind):
    """The kernel's algorithm on the CPU: counts from the rule on perturbed
    sums within the bound, plus the chain's categories of the undecided
    entries, equal ``fused_rank_counts_plain``'s counts."""
    _check_counts_with_the_recount(kind, torch.bfloat16)


@pytest.mark.parametrize("kind", F16_KINDS)
def test_f16_certified_counts_with_the_recount_equal_plain(kind):
    """The kernel's algorithm on the CPU in float16: counts equal
    ``fused_rank_counts_plain``'s, scores past float16's range and
    subnormal rows included; rows of subnormal values are not recounted
    whole (the tensor cores read them exactly, so their bound is finite)."""
    undecided = _check_counts_with_the_recount(kind, torch.float16)
    if kind == "subnormals":
        assert float(undecided[::3].float().mean()) < 0.05


def _check_counts_with_the_recount(kind, dtype):
    q, t, pivot_cols, score_map = _data(kind, seed=11 + len(kind), dtype=dtype)
    D = q.shape[1]
    n, m = q.shape[0], t.shape[0]
    row_ptr = torch.zeros(n + 1, dtype=torch.int32)
    cols = torch.zeros(0, dtype=torch.int32)
    g, c_, _, pivot = rank_kernel.fused_rank_counts_plain(
        q, t, None, row_ptr, cols, m, ATOL, RTOL, score_map=score_map,
        pivot_cols=pivot_cols.to(torch.int32))
    c = chain_sums(q, t)
    bound = certificate_bound(_exact_norm_bounds(q), _exact_norm_bounds(t), D)
    rng = np.random.default_rng(5)
    x = _sums_within(c, bound, rng)[-1]
    got = certified_categories(x, bound, pivot, ATOL, RTOL, score_map)
    undecided = got < 0
    exact = _categories(chain_scores(q, t), pivot, score_map)
    cat = torch.where(undecided, exact, got)
    assert torch.equal((cat == 2).sum(1, dtype=torch.int32), g)
    assert torch.equal((cat == 1).sum(1, dtype=torch.int32), c_)
    if kind == "nonfinite":
        assert bool(undecided[1:4].all())
    return undecided
