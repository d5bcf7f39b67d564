"""What only float16 has, in kge_tpu_torch against kge_tpu on the CPU
(``parallel.*_dtype: float16``; ROADMAP A.11a and A.11b). The routes both
dtypes share are in tests/test_torch_dtype_policy.py.

- Adagrad from a zero accumulator (its default) with float16 tables: its
  ``eps`` 1e-10 is a weakly typed Python constant, which rounds to 0 in
  float16, so an entry with a zero gradient computes 0/0 on the dense step.
  Both packages turn the same step's loss NaN and raise the same
  ``FloatingPointError`` at the end of the epoch. The port does not add an
  eps floor or loss scaling, which kge_tpu lacks.
- Evaluation of a float16 ComplEx and a float16 TransE-L2 model by both
  packages: ranks are equal on every (row, direction) whose float16 score
  row equals kge_tpu's bit for bit, and differ elsewhere by no more than the
  count of differing entries, as in bfloat16.
- The rank kernel's float16 path (its plain version) against kge_tpu's tie
  rule on float16 arrays: scores and pivots at +-inf (float16 overflows at
  65,520), the L2 epilogue's -0.0 (its 1e-30 rounds to 0 in float16), ties
  at the default atol (a float16 subnormal) and the self-tie.
- float16 checkpoints both ways between the packages through the CLI: numpy
  float16 leaves, no stand-in; and a float16 checkpoint of Adam on the
  fused row update (tables and moments float16) resumed by each package.
- The pooled ``cmod`` scores at zero and underflowing distances: kge_tpu's
  1e-30 rounds to 0 in float16, so their backward divides by 0 in both
  packages, with the same zeros, infinities and NaNs in the scores, dq and
  the selected pool rows.
- Adam on float16 tables: kge_tpu's NaN comes from the weakly typed bias
  correction of its dense rule (the int32 step), which its fused row
  update's dense fallback runs too; with its kernel's float32 step the rule
  stays finite, and so does the port's K4 (``KernelStep``).
"""

import shutil
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_torch_dtype_policy import _example_ranks, _score_rows
from tests.torch_parity import make_job_pair, run_steps, train_options
from tests.util import make_synthetic_dataset

BOTH = {"parallel.compute_dtype": "float16", "parallel.param_dtype": "float16"}
ATOL, RTOL = 1e-5, 1e-4  # entity_ranking.tie_handling's defaults


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    return make_synthetic_dataset(
        tmp_path_factory.mktemp("float16") / "float16_synth",
        num_entities=64, num_relations=4, num_train=256, seed=5)


def test_zero_accumulator_gives_kge_tpus_nan(synth):
    """Default Adagrad (``initial_accumulator_value`` 0) on float16 tables
    of 64 entities, which a batch of 6 leaves mostly untouched: the first
    step's untouched entries become 0/0 in both packages, the second step's
    loss is NaN in both, and an epoch raises kge_tpu's
    ``FloatingPointError`` in both."""
    options = {**train_options(), **BOTH, "train.epoch_scan": "never"}
    jjob, tjob = make_job_pair(synth, synth.name, options)
    losses = run_steps(jjob, tjob, steps=2)
    assert [np.isnan(j) for j, _ in losses] == [False, True]
    assert [np.isnan(t) for _, t in losses] == [False, True]
    np.testing.assert_allclose(losses[0][1], losses[0][0], rtol=5e-3)
    jjob, tjob = make_job_pair(synth, synth.name, options)
    for job in (jjob, tjob):
        with pytest.raises(FloatingPointError, match="Cost became nan"):
            job.run_epoch()


@pytest.mark.parametrize("model", ["complex", "transe_l2"])
def test_evaluation_matches_kge_tpu(synth, model):
    """A float16 model (both dtypes) evaluated by both packages, ranked in
    float16 with the tie test in float16. Per (row, direction), raw and
    filtered ranks are equal where the float16 score row equals kge_tpu's
    bit for bit, and differ by at most the count of differing entries
    elsewhere (kge_tpu's CPU product sums in another order than the rank
    kernel's chain). Most ComplEx rows agree bit for bit; TransE-L2's
    augmented operands hold squared norms, float16 sums over d that the two
    packages reduce in other orders."""
    from kge_tpu.job import EvaluationJob as JaxEvaluationJob
    from kge_tpu_torch.job import EvaluationJob
    from tests.torch_parity import make_pair, model_options

    name = "transe" if model == "transe_l2" else model
    options = {**model_options(name), **BOTH, "eval.trace_level": "example",
               "eval.split": "valid", "eval.batch_size": 64}
    if model == "transe_l2":
        options["transe.l_norm"] = 2.0
    jmodel, params, tmodel = make_pair(synth, synth.name, options, seed=5)
    assert tmodel.get_s_embedder().embeddings.dtype == torch.float16
    jranks, tranks = _example_ranks(jmodel.config), _example_ranks(tmodel.config)
    jjob = JaxEvaluationJob.create(jmodel.config, jmodel.dataset, model=jmodel)
    jjob.model_params, jjob.epoch = params, 0
    expected = jjob._evaluate()
    tjob = EvaluationJob.create(tmodel.config, tmodel.dataset, model=tmodel)
    tjob.epoch = 0
    with torch.inference_mode():
        got = tjob._evaluate()
    assert len(tranks) == len(jranks) == len(tmodel.dataset.split("valid"))

    triples = np.array([[e["s"], e["p"], e["o"]] for e in jranks])
    assert np.array_equal(triples, [[e["s"], e["p"], e["o"]] for e in tranks])
    rows = _score_rows(jmodel, params, tmodel, triples,
                       tmodel.dataset.num_entities(), dtype=torch.float16)
    equal_rows = 0
    for key in ("s", "o"):
        want, have = rows[key]
        differing = np.sum(want.view(np.int32) != have.view(np.int32), axis=1)
        for i, k in enumerate(differing):
            for suffix in ("", "_filtered"):
                field = f"rank_{key}{suffix}"
                delta = abs(jranks[i][field] - tranks[i][field])
                assert delta <= k, (key, i, field, delta, k)
        equal_rows += int(np.sum(differing == 0))
    if model == "complex":
        assert equal_rows >= len(triples)
    for metric in ("mean_reciprocal_rank_filtered", "hits_at_10_filtered"):
        assert abs(got[metric] - expected[metric]) <= 0.02, metric


def _tie_values():
    """float16 values at the tie rule's edges: the infinities, NaN, both
    zeros, the default atol (a subnormal) and its neighbours, neighbours of
    1 and the largest finite values."""
    atol = np.float16(ATOL)
    up, down = np.float16(np.inf), np.float16(-np.inf)
    values = [np.inf, -np.inf, np.nan, 0.0, -0.0, atol, np.nextafter(atol, up),
              np.nextafter(atol, down), -atol, 2 * atol, 1.0,
              np.nextafter(np.float16(1.0), up), np.nextafter(np.float16(1.0), down),
              1.0 + np.float16(RTOL), 65504.0, -65504.0, 65472.0, 2.0 ** -24]
    return np.array(values, dtype=np.float16)


def test_tie_rule_in_float16_as_kge_tpu():
    """The port's tie rule (``close_greater``: the rank kernel's plain
    version and the label recounts) against kge_tpu's ``_close_greater`` on
    float16 scores and pivots, every pair of edge values: atol and rtol
    round to float16 (atol to a subnormal), +inf against a +inf pivot is
    neither close nor greater, -inf against -inf is close, a finite score
    is close to a +inf pivot (its tolerance is infinite)."""
    from kge_tpu.ops.rank_kernel import _close_greater
    from kge_tpu_torch.ops.rank_kernel import close_greater

    values = _tie_values()
    scores, pivots = values[None, :], values[:, None]
    jclose, jgreater = _close_greater(jnp.asarray(scores), jnp.asarray(pivots),
                                      ATOL, RTOL)
    tclose, tgreater = close_greater(torch.tensor(scores), torch.tensor(pivots),
                                     ATOL, RTOL)
    assert np.array_equal(tclose.numpy(), np.asarray(jclose))
    assert np.array_equal(tgreater.numpy(), np.asarray(jgreater))
    inf = np.where(np.isposinf(values))[0][0]
    assert not tclose[inf, inf] and not tgreater[inf, inf]
    atol = np.where(values == np.float16(ATOL))[0][0]
    zero = np.where((values == 0) & ~np.signbit(values))[0][0]
    assert tclose[zero, atol] and not tclose[zero, atol + 1]


@pytest.mark.parametrize("epilogue", [False, True])
def test_rank_kernel_plain_float16_as_kge_tpu(epilogue):
    """The rank kernel's float16 path (plain version) on handmade operands
    whose products and sums are exact in every order, so that both
    packages' float16 scores are the same values: scores that overflow to
    +-inf, and under the L2 epilogue products at or above 0 that score
    -0.0. Its counts equal those of kge_tpu's tie rule on kge_tpu's float16
    score matrix (``_l2_factorization``'s epilogue), its pivots and label
    values equal that matrix's entries in bits, and every row's true column
    ties with itself unless its score is +inf."""
    from kge_tpu.models.translation import _l2_factorization
    from kge_tpu.ops.rank_kernel import _close_greater
    from kge_tpu_torch.ops.rank_kernel import (
        NEG_SQRT_L2,
        csr_row_ids,
        fused_rank_counts_plain,
    )

    rng = np.random.default_rng(7)
    n, E, D = 12, 40, 4
    q = rng.integers(-8, 9, (n, D)).astype(np.float16)
    t = rng.integers(-8, 9, (E, D)).astype(np.float16)
    # products past float16's range: 256 * 256 = 65,536 rounds to inf
    q[0], t[0] = [256, 256, 0, 0], [256, 0, 0, 0]
    q[1], t[1] = [-256, 0, 0, 0], [256, 256, 0, 0]
    q[2] = 0.0  # every product 0, -0.0 under the epilogue
    true = rng.integers(0, E, n).astype(np.int32)
    true[:3] = [0, 1, 5]
    per_row = [np.sort(rng.choice(E, size=int(rng.integers(1, 6)), replace=False))
               for _ in range(n)]
    row_ptr = np.concatenate([[0], np.cumsum([len(c) for c in per_row])])
    cols = np.concatenate(per_row).astype(np.int32)

    jmap = _l2_factorization(jnp.zeros((1, D), jnp.float16))[2] if epilogue else None
    jscores = jnp.asarray(q) @ jnp.asarray(t).T
    if epilogue:
        jscores = jmap(jscores)
    jscores = np.asarray(jscores)
    assert jscores.dtype == np.float16
    jpivot = jscores[np.arange(n), true]
    jclose, jgreater = _close_greater(jnp.asarray(jscores), jnp.asarray(jpivot)[:, None],
                                      ATOL, RTOL)

    g, c, vals, pivot = fused_rank_counts_plain(
        torch.tensor(q), torch.tensor(t), None, torch.tensor(row_ptr.astype(np.int32)),
        torch.tensor(cols), E, ATOL, RTOL, score_map=NEG_SQRT_L2 if epilogue else None,
        pivot_cols=torch.tensor(true))
    assert vals.dtype == pivot.dtype == torch.float16
    assert np.array_equal(g.numpy(), np.asarray(jgreater).sum(1))
    assert np.array_equal(c.numpy(), np.asarray(jclose).sum(1))
    assert np.array_equal(pivot.numpy().view(np.int16), jpivot.view(np.int16))
    rows = csr_row_ids(torch.tensor(row_ptr)).numpy()
    assert np.array_equal(vals.numpy().view(np.int16),
                          jscores[rows, cols].view(np.int16))
    if epilogue:
        assert np.isneginf(jpivot[1])  # -(-65,536): sqrt of inf
        assert np.signbit(jpivot[2]) and jpivot[2] == 0  # -0.0
        assert np.all(np.signbit(jscores[2]) & (jscores[2] == 0))
    else:
        assert np.isposinf(jpivot[0]) and np.isneginf(jpivot[1])
    self_close = np.asarray(jclose)[np.arange(n), true]
    assert np.array_equal(self_close, ~np.isposinf(jpivot))


def test_float16_checkpoints_cross_both_ways(tmp_path):
    """kge_tpu starts the toy config with both dtypes in float16 (Adagrad
    from 0.1, on ``train.epoch_scan: never``) and the port resumes its
    initial checkpoint; the port starts the same and kge_tpu resumes the
    port's. Each pair's two epochs agree within rtol 5e-3, the initial
    checkpoints hold float16 numpy tables, and the last ones leaves of the
    same dtypes (float32: the dense step promotes, ROADMAP C.4)."""
    from kge_tpu_torch.models.convert import leaf_tensor
    from kge_tpu_torch.utils.io import load_checkpoint
    from tests.test_torch_cli import EXAMPLES_DIR, _entries, _run, _toy_cwd

    cwd = _toy_cwd(tmp_path)
    args = [str(EXAMPLES_DIR / "toy-complex-train.yaml"),
            "--parallel.compute_dtype", "float16", "--parallel.param_dtype",
            "float16", "--train.optimizer.default.args.initial_accumulator_value",
            "0.1", "--train.epoch_scan", "never", "--train.max_epochs", "2",
            "--valid.every", "0"]
    device = {"kge_tpu": [], "kge_tpu_torch": ["--job.device", "cpu"]}
    for starter, resumer in (("kge_tpu", "kge_tpu_torch"),
                             ("kge_tpu_torch", "kge_tpu")):
        started, resumed = cwd / f"{starter}_start", cwd / f"{resumer}_resume"
        _run([sys.executable, "-m", starter, "start", *args, *device[starter],
              "--folder", str(started)], cwd=cwd)
        initial = load_checkpoint(str(started / "checkpoint_00000.pt"))
        table = initial["model"][0]["entity_embedder"]["embeddings"]
        assert isinstance(table, np.ndarray) and table.dtype == np.float16
        resumed.mkdir()
        for name in ("config.yaml", "checkpoint_00000.pt"):
            shutil.copy(started / name, resumed / name)
        _run([sys.executable, "-m", resumer, "resume", str(resumed),
              *device[resumer]], cwd=cwd)
        losses = [[e["avg_loss"] for e in _entries(folder, event="epoch_completed")]
                  for folder in (resumed, started)]
        assert len(losses[0]) == 2
        np.testing.assert_allclose(losses[0], losses[1], rtol=5e-3)
        dtypes = [{key: leaf_tensor(leaf["embeddings"]).dtype
                   for key, leaf in load_checkpoint(str(
                       folder / "checkpoint_00002.pt"))["model"][0].items()}
                  for folder in (resumed, started)]
        assert dtypes[0] == dtypes[1]


# -- the pooled cmod scores at zero and underflowing distances ------------------


def _cmod_edge_inputs():
    """(q parts, pool parts, sel, g) in float16, n 6, K 4, F 3, d 8. Pair
    (0, 1): a zero distance in every column; pair (4, 0): the same with g =
    0; pair (2, 3): in columns 0-2 both differences are 2^-13 or 0 at values
    of 0.1875, whose squares underflow to 0 (below 2^-25), in the other
    columns a normal distance. Every other value lies in [0.25, 1) in
    magnitude, so that kge_tpu's zero padding of rows and slots adds no
    zero distance."""
    rng = np.random.default_rng(11)
    n, K, F, d = 6, 4, 3, 8

    def values(*shape):
        x = rng.uniform(0.25, 1.0, shape) * rng.choice([-1.0, 1.0], shape)
        return x.astype(np.float16)

    qs, pools = [values(n, d), values(n, d)], [values(K * F, d), values(K * F, d)]
    sel = rng.integers(0, F, (n, K)).astype(np.int32)
    g = values(n, K)
    for i, j in ((0, 1), (4, 0)):
        for q, p in zip(qs, pools):
            q[i] = p[j * F + sel[i, j]]
    g[4, 0] = 0.0
    row = 3 * F + sel[2, 3]
    for q, p in zip(qs, pools):
        p[row, :3] = 0.1875
        q[2, :3] = 0.1875
    qs[0][2, :3] += np.float16(2.0 ** -13)  # both parts in column 0, one in 1-2
    qs[1][2, 0] += np.float16(2.0 ** -13)
    return qs, pools, sel, g


def test_cmod_zero_distances_as_kge_tpu():
    """``cmod`` in float16 at zero distances (0 - 0 in both parts) and at
    distances whose squares underflow: kge_tpu's weakly typed 1e-30 rounds
    to 0, so the distance is 0, the score 0 where every column is, and the
    backward's ``g rsqrt(0) diff`` is +-inf, or NaN where diff or g is 0.
    The port's plain version (autograd's ``g / (2 sqrt(0))`` times 2 diff)
    gives the same: scores, dq and the dpool row each such pair selected
    have NaN and +-inf in kge_tpu's places, with kge_tpu's signs, and agree
    elsewhere within 4 float16 ulps of the summed magnitudes (the float16
    tolerance of tests/test_torch_dtype_policy.py). One place differs, by
    design (ROADMAP C.4): kge_tpu selects candidates by a one-hot sum over
    the slot's F pool rows, so a non-finite factor reaches the slot's other
    rows too, as 0 x inf = NaN; the port gathers the selected row, and
    those rows stay finite."""
    import jax

    from kge_tpu.ops.dist_pool import pooled_dist_scores as jax_pooled
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores

    qs, pools, sel, g = _cmod_edge_inputs()
    n, K = sel.shape
    F, d = pools[0].shape[0] // K, qs[0].shape[1]

    def jax_fn(*tensors):
        return jax_pooled(list(tensors[:2]), list(tensors[2:]), jnp.asarray(sel), F,
                          "cmod")

    want, vjp = jax.vjp(jax_fn, *(jnp.asarray(x) for x in (*qs, *pools)))
    want_grads = [np.asarray(x, np.float32) for x in vjp(jnp.asarray(g))]
    want = np.asarray(want, np.float32)
    tensors = [torch.tensor(x).requires_grad_(True) for x in (*qs, *pools)]
    got = pooled_dist_scores(tensors[:2], tensors[2:], torch.tensor(sel), F, "cmod")
    grads = torch.autograd.grad(got, tensors, torch.tensor(g))
    assert got.dtype == torch.float16 and all(x.dtype == torch.float16 for x in grads)
    got = got.detach().float().numpy()
    grads = [x.float().numpy() for x in grads]

    # the pairs' distances in float16, column by column: 0 exactly where the
    # handmade pairs have them
    rows = np.arange(K)[None, :] * F + sel
    diffs = [(q[:, None, :].astype(np.float32) - p[rows].astype(np.float32))
             .astype(np.float16) for q, p in zip(qs, pools)]
    squares = (diffs[0] * diffs[0] + diffs[1] * diffs[1]).astype(np.float16)
    zero = squares == 0
    assert zero[0, 1].all() and zero[4, 0].all() and zero[2, 3, :3].all()
    assert zero.sum() == 2 * d + 3 and (diffs[0][2, 3, :3] != 0).all()
    assert got[0, 1] == want[0, 1] == 0 and got[4, 0] == want[4, 0] == 0

    def same_non_finite(a, b):
        assert np.array_equal(np.isnan(a), np.isnan(b))
        assert np.array_equal(np.isposinf(a), np.isposinf(b))
        assert np.array_equal(np.isneginf(a), np.isneginf(b))

    unit = 2.0 ** -11
    dist = np.sqrt(squares.astype(np.float32))
    _close(got, want, 4 * unit * dist.sum(axis=2))
    dq_mag = 2 * np.abs(g.astype(np.float32)).sum(axis=1)[:, None] * np.ones((1, d))
    for i in range(2):
        same_non_finite(grads[i], want_grads[i])
        assert not np.isfinite(grads[i][[0, 2, 4]]).all()
        finite = np.isfinite(want_grads[i])
        _close(grads[i][finite], want_grads[i][finite], 4 * unit * dq_mag[finite])
    # dpool: a non-finite factor in the selected row in both packages; in
    # kge_tpu also as NaN in the slot's other rows
    hit = np.zeros((K * F, d), bool)
    slot_hit = np.zeros((K, d), bool)
    for i, j in zip(*np.nonzero(zero.any(axis=2))):
        hit[rows[i, j]] |= zero[i, j]
        slot_hit[j] |= zero[i, j]
    spread = np.repeat(slot_hit, F, axis=0) & ~hit
    assert spread.sum() > 0
    dpool_mag = np.zeros((K * F, d), np.float32)
    np.add.at(dpool_mag, rows.reshape(-1), 2 * np.abs(g.astype(np.float32)).reshape(-1, 1)
              * np.ones(d))
    for i in range(2, 4):
        port, jax_ = grads[i], want_grads[i]
        assert np.isnan(jax_[spread]).all() and np.isfinite(port[spread]).all()
        assert not np.isfinite(port[hit]).any()
        same_non_finite(port[~spread], jax_[~spread])
        finite = np.isfinite(jax_)
        _close(port[finite], jax_[finite], 4 * unit * dpool_mag[finite])


def _close(got, want, bound):
    """|got - want| <= bound + 1e-6, element by element."""
    excess = np.abs(np.asarray(got, np.float32) - np.asarray(want, np.float32)) - (
        bound + 1e-6)
    assert np.all(excess <= 0), float(np.max(excess))


# -- Adam on float16 tables: where kge_tpu's NaN comes from ----------------------


def test_adam_nan_comes_from_the_weakly_typed_bias_correction():
    """kge_tpu's Adam rule on float16 arrays from zero moments, where a row
    has zero gradient: with its dense step's int32 step count the bias
    corrections are weakly typed, so ``m_hat`` and ``v_hat`` stay float16,
    ``eps`` 1e-8 rounds to 0, and those entries compute 0/0; with its fused
    kernel's float32 step (kge_tpu/ops/pallas_ops.py) they are float32
    terms, eps stays 1e-8, and the step is finite. The port's rule gives
    the same NaNs with an int step (the dense step) and the same finite
    step with ``KernelStep`` (its K4 and K4's plain version), within one
    float16 ulp of kge_tpu's."""
    from kge_tpu.ops.optim import _RULES as JAX_RULES
    from kge_tpu_torch.ops.optim import _RULES, KernelStep

    rng = np.random.default_rng(4)
    rows, d, lr = 12, 16, 1e-3
    param = rng.normal(0, 0.5, (rows, d)).astype(np.float16)
    grad = rng.normal(0, 1e-2, (rows, d)).astype(np.float16)
    grad[::3] = 0  # untouched rows
    untouched = np.zeros((rows, d), bool)
    untouched[::3] = True
    zeros = np.zeros((rows, d), np.float16)

    def jax_step(step):
        delta, _ = JAX_RULES["adam"][1](
            jnp.asarray(grad), {"m": jnp.asarray(zeros), "v": jnp.asarray(zeros)},
            jnp.asarray(param), jnp.float32(lr), step, {})
        return np.asarray(delta, np.float32)

    def port_step(step):
        delta, _ = _RULES["adam"][1](
            torch.tensor(grad), {"m": torch.tensor(zeros), "v": torch.tensor(zeros)},
            torch.tensor(param), lr, step, {})
        return delta.float().numpy()

    dense_jax, kernel_jax = jax_step(jnp.int32(0)), jax_step(jnp.float32(0))
    dense_port, kernel_port = port_step(0), port_step(KernelStep(0))
    assert np.array_equal(np.isnan(dense_jax), untouched)
    assert np.array_equal(np.isnan(dense_port), untouched)
    assert np.isfinite(kernel_jax).all() and np.isfinite(kernel_port).all()
    assert (kernel_jax[untouched] == 0).all() and (kernel_port[untouched] == 0).all()
    # the new parameter, stored in float16, within one float16 ulp
    want = (param.astype(np.float32) + kernel_jax).astype(np.float16).astype(np.float32)
    got = (param.astype(np.float32) + kernel_port).astype(np.float16).astype(np.float32)
    assert np.all(np.abs(got - want) <= 2.0 ** -10 * np.abs(want) + 2.0 ** -24)


def test_rotate_adam_on_float16_tables_nans_only_in_kge_tpus_fallback(synth):
    """RotatE with Adam on the fused row-sparse step, both dtypes float16,
    on 64 entities (a batch leaves most rows untouched), the same batches
    and pools in both packages. kge_tpu takes its fused kernel's dense
    fallback at d = 8 (its kernel could not store into a float16 tile at
    any width, ROADMAP C.4): the first step turns the untouched entries
    NaN, and the second step's loss is NaN. The port's K4 keeps kge_tpu's
    kernel semantics (a float32 step) and stays finite; on the dense step
    (``train.sparse_embedding_update: never``) it runs kge_tpu's dense rule
    and meets the same NaN at the same step."""
    from tests.test_torch_dtype_policy import ROTATE_FUSED

    options = {**ROTATE_FUSED, **BOTH, "train.epoch_scan": "never"}
    jjob, tjob = make_job_pair(synth, synth.name, options)
    assert tjob._sparse_update
    losses = run_steps(jjob, tjob, steps=2)
    assert [np.isnan(j) for j, _ in losses] == [False, True]
    assert [np.isnan(t) for _, t in losses] == [False, False]
    np.testing.assert_allclose(losses[0][1], losses[0][0], rtol=5e-3)
    for table in tjob.optimizer.params:
        assert table.dtype == torch.float16 and bool(torch.isfinite(table).all())

    dense = {**options, "train.sparse_embedding_update": "never"}
    jjob, tjob = make_job_pair(synth, synth.name, dense)
    assert not tjob._sparse_update
    losses = run_steps(jjob, tjob, steps=2)
    assert [np.isnan(t) for _, t in losses] == [False, True]
    assert [np.isnan(j) for j, _ in losses] == [False, True]


ROTATE_F16_CONFIG = """\
job.device: cpu
dataset.name: dataset_test
model: rotate
train:
  type: negative_sampling
  max_epochs: 1
  batch_size: 6
  loss: bce_self_adversarial
  optimizer.default.type: Adam
  optimizer.default.args.lr: 0.001
  optimizer.default.args.eps: 1.0e-4
  sparse_embedding_update: always
  epoch_scan: never
negative_sampling:
  shared: false
  implementation: pool
  pool_factor: 3
  pooled_kernel: always
  num_samples: {s: 4, o: 4}
lookup_embedder.dim: 8
valid.every: 0
random_seed.default: 1
parallel.compute_dtype: float16
parallel.param_dtype: float16
"""


def test_float16_adam_checkpoint_of_the_fused_step_resumes_in_both(tmp_path):
    """The port starts RotatE with Adam on the fused row update with both
    dtypes float16 (pooled cmod scores through K5's plain version) for one
    epoch: its checkpoint holds float16 tables and float16 Adam moments.
    Each package resumes it for a second epoch: the losses agree within
    rtol 5e-3. Adam's eps is 1e-4: with 1e-8, a gradient entry whose v =
    0.001 g^2 underflows in float16 takes a step of lr |g| 1e8, which
    overflows the table in some draws, in both packages (ROADMAP C.4). The port's tables and moments stay float16; kge_tpu's fused
    step takes its dense fallback and turns the tables float32 (ROADMAP
    C.4)."""
    from kge_tpu_torch.models.convert import leaf_tensor
    from kge_tpu_torch.utils.io import load_checkpoint
    from tests.test_torch_cli import _entries, _run, _toy_cwd

    cwd = _toy_cwd(tmp_path)
    config = cwd / "rotate_f16.yaml"
    config.write_text(ROTATE_F16_CONFIG)
    started = cwd / "started"
    _run([sys.executable, "-m", "kge_tpu_torch", "start", str(config), "--folder",
          str(started)], cwd=cwd)
    saved = load_checkpoint(str(started / "checkpoint_00001.pt"))
    for leaf in saved["model"][0].values():
        table = leaf["embeddings"]
        assert isinstance(table, np.ndarray) and table.dtype == np.float16
    for leaf in saved["optimizer_state"]["leaves"]:
        assert {k: v.dtype for k, v in leaf.items()} == {"m": np.float16,
                                                         "v": np.float16}
    losses, tables = {}, {}
    for package in ("kge_tpu_torch", "kge_tpu"):
        folder = cwd / package
        folder.mkdir()
        for name in ("config.yaml", "checkpoint_00001.pt"):
            shutil.copy(started / name, folder / name)
        _run([sys.executable, "-m", package, "resume", str(folder),
              "--train.max_epochs", "2"], cwd=cwd)
        (entry,) = _entries(folder, event="epoch_completed")
        assert entry["epoch"] == 2
        losses[package] = entry["avg_loss"]
        last = load_checkpoint(str(folder / "checkpoint_00002.pt"))
        tables[package] = {leaf_tensor(v["embeddings"]).dtype
                           for v in last["model"][0].values()}
    np.testing.assert_allclose(losses["kge_tpu_torch"], losses["kge_tpu"], rtol=5e-3)
    assert tables == {"kge_tpu_torch": {torch.float16}, "kge_tpu": {torch.float32}}
