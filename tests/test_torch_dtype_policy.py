"""kge_tpu's dtype policy in kge_tpu_torch, against kge_tpu on the CPU:
``parallel.compute_dtype: bfloat16`` (tables in float32) and both dtypes in
bfloat16; the same in float16 ("f16_compute", "f16_both") on every route
(K1, K2 and K3 since ROADMAP A.11a, K4 and K5 since A.11b).

- Training: every ``train.type`` (negative sampling with ComplEx, 1vsAll,
  KvsAll with label smoothing), TransE-L1 with the pool through the pooled
  kernel's plain version, RotatE with Adam on the fused row-sparse step,
  TransE with Adagrad on the row-sparse write, and reciprocal ConvE. The
  same batches and negatives go through both packages' raw steps (kge_tpu
  on ``train.epoch_scan: never``, ROADMAP C.3 and C.4). Every parameter and
  optimizer-state leaf has kge_tpu's dtype after every step (kge_tpu's
  dense step turns a bfloat16 table float32, ROADMAP C.4, and so does the
  port's), and losses and tables agree within bfloat16 tolerances: losses
  rtol 2e-2, tables atol 2e-2 plus rtol 2e-2 (about five bfloat16 ulps,
  2^-8 each relative, at the tables' magnitudes of 0.1 to 1 and the
  batch-norm variances' of 10 to 30; the two packages sum bfloat16
  products in other orders, and a rounding that differs once moves a later
  step's result by an ulp). In float16 (negative sampling, 1vsAll, KvsAll,
  TransE-L1 with the pool and on the row-sparse write, RotatE on the fused
  step, ConvE): losses rtol 5e-3, tables atol 5e-3 plus rtol 5e-3, about
  five float16 ulps (2^-10 relative) at the tables' magnitudes of 0.1 to 1,
  for the same reason.
- Each kernel's plain bfloat16 and float16 versions against kge_tpu's
  function, run as kge_tpu's own tests run it (interpret mode on the CPU):
  the scatter (K2), the row write (K3), the fused row update (K4), the
  pooled distance scores and their backward (K5a, K5b).
- Evaluation of one bfloat16 model by both packages: ranks are equal on
  every (row, direction) whose bfloat16 score row equals kge_tpu's bit for
  bit, and differ elsewhere by no more than the count of differing entries.
- bfloat16 checkpoints both ways between the packages, through the CLI.
- The card's bfloat16 kernels against their plain versions
  (``tests/test_torch_cuda.py`` holds them, marked ``cuda``).
"""

import jax
import jax.numpy as jnp
import ml_dtypes
import numpy as np
import pytest
import torch

from tests.torch_parity import (
    jax_tables,
    make_job_pair,
    neural_options,
    pooled_options,
    run_batch_steps,
    run_steps,
    train_options,
)
from tests.util import DATASET_DIR, make_synthetic_dataset

SETTINGS = {
    "compute": {"parallel.compute_dtype": "bfloat16"},
    "both": {"parallel.compute_dtype": "bfloat16",
             "parallel.param_dtype": "bfloat16"},
    "f16_compute": {"parallel.compute_dtype": "float16"},
    "f16_both": {"parallel.compute_dtype": "float16",
                 "parallel.param_dtype": "float16"},
}

#: bfloat16 tolerances of the training comparison (module docstring)
LOSS_RTOL = 2e-2
TABLE_ATOL = 2e-2
TABLE_RTOL = 2e-2
#: float16 tolerances: (loss rtol, table atol, table rtol)
TOLERANCES = {"bfloat16": (LOSS_RTOL, TABLE_ATOL, TABLE_RTOL),
              "float16": (5e-3, 5e-3, 5e-3)}


def _dtype_of(setting) -> str:
    """The narrow dtype a setting names."""
    return "float16" if str(setting).startswith("f16") else "bfloat16"

#: Adagrad from a non-zero accumulator and smooth losses: from a zero
#: accumulator Adagrad's first step is +-lr times the sign of each gradient
#: entry, and a hinge switches a whole row; either turns a rounding in the
#: last bfloat16 bit of a near-zero gradient into a step of 2 lr
ADAGRAD = {"train.optimizer.default.args.initial_accumulator_value": 0.1}

CASES = {
    "negative_sampling": (train_options(**ADAGRAD), "negatives"),
    "1vsAll": (train_options(**{"train.type": "1vsAll", **ADAGRAD}), "batches"),
    "KvsAll": (train_options(**{"train.type": "KvsAll",
                                "KvsAll.label_smoothing": 0.2, **ADAGRAD}),
               "batches"),
    "transe_pool": (pooled_options(
        "transe", **{"negative_sampling.pooled_kernel": "always",
                     "train.loss": "kl", **ADAGRAD}), "negatives"),
    "transe_rows": (pooled_options(
        "transe", **{"train.sparse_embedding_update": "always",
                     "train.loss": "kl", **ADAGRAD}), "negatives"),
}

#: RotatE with Adam on the fused row-sparse step (the pooled kernel's and
#: the fused update's plain versions)
ROTATE_FUSED = pooled_options(
    "rotate", **{"negative_sampling.pooled_kernel": "always",
                 "train.sparse_embedding_update": "always"})

#: the routes float16 trains on: every route, RotatE's fused step among them
#: (in bfloat16 it has a test of its own, below)
F16_CASES = ("1vsAll", "KvsAll", "negative_sampling", "rotate_fused",
             "transe_pool", "transe_rows")
ALL_CASES = {**CASES, "rotate_fused": (ROTATE_FUSED, "negatives")}
#: (case, setting) of the training comparison
TRAINING = [(case, setting) for setting in ("both", "compute")
            for case in sorted(CASES)] + [
    (case, setting) for setting in ("f16_both", "f16_compute")
    for case in F16_CASES]

#: reciprocal ConvE, 1vsAll with Adagrad
CONVE = neural_options("conve", **{
    "train.type": "1vsAll", "train.batch_size": 6,
    "train.optimizer.default.type": "Adagrad",
    "train.optimizer.default.args.lr": 0.1, "valid.every": 0, **ADAGRAD})


def _np(x):
    """A leaf as float32 numpy, whatever its dtype."""
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x).astype(np.float32)


def _dtype_name(x) -> str:
    return str(x.dtype).replace("torch.", "")


def _leaf_dtypes(jjob, tjob):
    jparams = [_dtype_name(np.asarray(v)) for v in jax_tables(jjob)]
    tparams = [_dtype_name(p) for p in tjob.optimizer.params]
    jstates = [{k: _dtype_name(np.asarray(v)) for k, v in leaf.items()}
               for leaf in jjob.opt_state["leaves"]]
    tstates = [{k: _dtype_name(v) for k, v in leaf.items()}
               for leaf in tjob.opt_state["leaves"]]
    return (jparams, jstates), (tparams, tstates)


def _options(options, setting):
    return {**options, **SETTINGS.get(setting, {}), "train.epoch_scan": "never"}


def _step(jjob, tjob, kind, step):
    """One step of both jobs (same batch, same negatives); (jax loss, torch
    loss)."""
    if kind == "negatives":
        return run_steps(jjob, tjob, steps=1, seed=3 + step)[0]
    return run_batch_steps(jjob, tjob, steps=1)[0]


def _assert_tables_close(jjob, tjob, dtype="bfloat16"):
    _, atol, rtol = TOLERANCES[dtype]
    for t, j in zip(tjob.optimizer.params, jax_tables(jjob), strict=True):
        np.testing.assert_allclose(_np(t), _np(j), atol=atol, rtol=rtol)


@pytest.mark.parametrize("case,setting", TRAINING,
                         ids=[f"{c}-{s}" for c, s in TRAINING])
def test_training_matches_kge_tpu(case, setting):
    """Every leaf keeps kge_tpu's dtype, but on RotatE's fused step with
    float16 tables: kge_tpu's fused kernel cannot store its rule's float32
    result into a float16 tile, and at widths off its 128-lane tiling it
    takes its dense fallback, whose tables turn float32; the port's K4
    keeps the table and its Adam moments float16, as in bfloat16 (ROADMAP
    C.4). Their values agree within the float16 tolerances all the same.
    On this 7-entity graph every row is touched at every step, so kge_tpu's
    fallback stays finite; where rows go untouched it turns NaN and the
    port's fused step does not (tests/test_torch_float16.py)."""
    options, kind = ALL_CASES[case]
    dtype = _dtype_of(setting)
    loss_rtol = TOLERANCES[dtype][0]
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test",
                               _options(options, setting))
    want, got = _leaf_dtypes(jjob, tjob)
    assert got == want
    param_dtype = dtype if setting.endswith("both") else "float32"
    assert want[0][0] == param_dtype  # the entity table, before a step
    keeps_tables = case == "rotate_fused" and setting == "f16_both"
    for step in range(3):
        jloss, tloss = _step(jjob, tjob, kind, step)
        np.testing.assert_allclose(tloss, jloss, rtol=loss_rtol)
        want, got = _leaf_dtypes(jjob, tjob)
        if keeps_tables:
            assert want[0] == ["float32", "float32"], step
            assert got == (["float16"] * 2, [{"m": "float16", "v": "float16"}] * 2)
        else:
            assert got == want, step
    _assert_tables_close(jjob, tjob, dtype)


def test_fused_row_update_keeps_bfloat16_tables():
    """Both dtypes in bfloat16 on the fused row-sparse step: the port's
    tables and Adam states stay bfloat16, as kge_tpu's kernel declares them
    (its output is the table's dtype). kge_tpu cannot run that kernel on a
    bfloat16 table: its rule's float32 result does not store into the
    bfloat16 tile (ROADMAP C.4); at widths off its 128-lane tiling it takes
    its dense fallback, whose tables turn float32. Against that fallback
    the values agree within the bfloat16 tolerances."""
    options = _options(ROTATE_FUSED, "both")
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", options)
    for step in range(3):
        jloss, tloss = _step(jjob, tjob, "negatives", step)
        np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    want, got = _leaf_dtypes(jjob, tjob)
    assert want[0] == ["float32", "float32"]
    assert got[0] == ["bfloat16", "bfloat16"]
    assert got[1] == [{"m": "bfloat16", "v": "bfloat16"}] * 2
    _assert_tables_close(jjob, tjob)

    wide = {**options, "lookup_embedder.dim": 128}
    jjob, tjob = make_job_pair(DATASET_DIR, "dataset_test", wide)
    with pytest.raises(ValueError, match="Invalid dtype"):
        _step(jjob, tjob, "negatives", 0)


@pytest.fixture(scope="module")
def synth(tmp_path_factory):
    """64 entities: batch norm over dataset_test's batches of 6 amplifies
    rounding past any tolerance (tests/test_torch_neural.py)."""
    return make_synthetic_dataset(
        tmp_path_factory.mktemp("dtype_policy") / "dtype_synth",
        num_entities=64, num_relations=4, num_train=256, seed=5)


@pytest.mark.parametrize("setting", sorted(SETTINGS))
def test_conve_computes_in_float32_where_kge_tpu_raises(synth, setting):
    """ConvE's float32 scorer parameters meet the bfloat16 embeddings in
    float32 in the port, as JAX promotes mixed operands; kge_tpu's
    convolution refuses the mix (``lax.conv_general_dilated requires
    arguments to have the same dtypes``, ROADMAP C.4), in bfloat16 and in
    float16. The port's steps agree with kge_tpu's float32 steps from the
    same weights within the bfloat16 tolerances, and its leaves have the
    policy's dtypes. What differs is the rounding of the embeddings to the
    narrow dtype, which batch norm amplifies; float16 rounds 8 times finer
    than bfloat16, so the bfloat16 tolerances bound it too (float16 tables
    come within 9e-3 of the float32 steps, beyond the float16 parity
    tolerance of the other routes, which compare float16 with float16)."""
    options = _options({**CONVE, "train.batch_size": 32}, setting)
    jjob16, tjob = make_job_pair(synth, synth.name, options)
    with pytest.raises(TypeError, match="same dtypes"):
        _step(jjob16, tjob, "batches", 0)
    jjob, _ = make_job_pair(synth, synth.name,
                            _options({**CONVE, "train.batch_size": 32}, None))
    for step in range(3):
        jloss, tloss = _step(jjob, tjob, "batches", step)
        np.testing.assert_allclose(tloss, jloss, rtol=LOSS_RTOL)
    _assert_tables_close(jjob, tjob)
    tables, states = _leaf_dtypes(jjob, tjob)[1]
    # the dense step leaves every leaf float32, the bfloat16 tables included
    assert set(tables) == {"float32"}
    assert {v for leaf in states for v in leaf.values()} == {"float32"}


# -- each kernel's plain bfloat16 version against kge_tpu's function ---------


def _bf16(rng, *shape, scale=1.0):
    """(numpy float32 values exact in bfloat16, the same as a bfloat16
    tensor, as a bfloat16 jax array)."""
    x = (rng.normal(0.0, scale, shape).astype(np.float32)
         .astype(ml_dtypes.bfloat16).astype(np.float32))
    return x, torch.tensor(x).bfloat16(), jnp.asarray(x, jnp.bfloat16)


def _f16(rng, *shape, scale=1.0):
    """The same in float16."""
    x = rng.normal(0.0, scale, shape).astype(np.float16).astype(np.float32)
    return x, torch.tensor(x).half(), jnp.asarray(x, jnp.float16)


#: per dtype: (its unit roundoff, the values of _bf16 / _f16, torch dtype)
NARROW = {"bfloat16": (2.0 ** -8, _bf16, torch.bfloat16),
          "float16": (2.0 ** -11, _f16, torch.float16)}


def _close_in_bf16(got: torch.Tensor, want, magnitude, ulps: int = 2,
                   unit: float = 2.0 ** -8):
    """|got - want| <= ulps bfloat16 ulps of ``magnitude`` (the summed
    absolute terms of each entry) plus 1e-6: two float32 sums of the same
    bfloat16 terms in other orders, each rounded once. ``unit``: the unit
    roundoff, float16's for float16."""
    got, want = _np(got), _np(want)
    bound = 1e-6 + ulps * unit * np.asarray(magnitude, np.float32)
    assert np.all(np.abs(got - want) <= bound), float(
        np.max(np.abs(got - want) - bound))


def _scatter_plain_matches_kge_tpu(dtype):
    from kge_tpu.ops import pallas_ops
    from kge_tpu_torch.ops.embedding_ops import (
        sorted_scatter_add,
        sorted_segment_sums,
    )

    unit, values, tdtype = NARROW[dtype]
    rng = np.random.default_rng(0)
    n, rows, d = 300, 40, 128
    ids = rng.integers(0, rows, n)
    upd, upd_t, upd_j = values(rng, n, d)
    want = pallas_ops.sorted_scatter_add(jnp.asarray(ids), upd_j, rows,
                                         interpret=True)
    got = sorted_scatter_add(torch.tensor(ids), upd_t, rows)
    assert got.dtype == tdtype and want.dtype == jnp.dtype(dtype)
    magnitude = np.zeros((rows, d), np.float32)
    np.add.at(magnitude, ids, np.abs(upd))
    _close_in_bf16(got, want, magnitude, unit=unit)
    rs, seg, gsum = sorted_segment_sums(torch.tensor(ids), upd_t, rows)
    assert gsum.dtype == tdtype
    distinct = np.unique(ids)
    _close_in_bf16(gsum[:len(distinct)], np.asarray(want, np.float32)[distinct],
                   magnitude[distinct], unit=unit)


def test_scatter_plain_matches_kge_tpu():
    """K2: bfloat16 updates summed in float32 and rounded once to
    bfloat16, against kge_tpu's kernel in interpret mode."""
    _scatter_plain_matches_kge_tpu("bfloat16")


def test_scatter_plain_matches_kge_tpu_in_float16():
    """K2 in float16, as in bfloat16: the port rounds each output element
    once; kge_tpu adds each chunk's float32 sum into its float16 output, so
    a row whose updates span chunks is rounded once a chunk: within two
    float16 ulps (2^-11 relative each) of the summed magnitudes."""
    _scatter_plain_matches_kge_tpu("float16")


def _rows_set_plain_matches_kge_tpu(dtype):
    from kge_tpu.ops import pallas_ops
    from kge_tpu_torch.ops.embedding_ops import rows_set

    _, values, tdtype = NARROW[dtype]
    rng = np.random.default_rng(1)
    _, table_t, table_j = values(rng, 50, 128)
    _, rows_t, rows_j = values(rng, 4, 128)
    rows_t[2] = rows_t[1]
    rows_j = rows_j.at[2].set(rows_j[1])
    ids = np.array([4, 9, 9, 30])
    want = pallas_ops.rows_set(table_j, jnp.asarray(ids), rows_j, interpret=True)
    got = rows_set(table_t.clone(), torch.tensor(ids), rows_t)
    assert got.dtype == tdtype and want.dtype == jnp.dtype(dtype)
    assert np.array_equal(_np(got), _np(want))


def test_rows_set_plain_matches_kge_tpu():
    """K3: 2-byte rows into a bfloat16 table, bit for bit."""
    _rows_set_plain_matches_kge_tpu("bfloat16")


def test_rows_set_plain_matches_kge_tpu_in_float16():
    """K3: 2-byte rows into a float16 table, bit for bit."""
    _rows_set_plain_matches_kge_tpu("float16")


FUSED_RULES = [
    ("adagrad", {}), ("adagrad", {"weight_decay": 0.01, "lr_decay": 0.1}),
    ("adam", {}), ("adamw", {"weight_decay": 0.1}), ("adamax", {}),
    ("sgd", {"momentum": 0.9, "nesterov": True}),
    ("rmsprop", {"momentum": 0.5, "centered": True}), ("adadelta", {}),
]


def _fused_plain_matches_kge_tpu_rule(opt_type, args, dtype):
    from kge_tpu.ops.optim import _RULES as JAX_RULES
    from kge_tpu_torch.ops.optim import _RULES, fused_sorted_update

    unit, values, tdtype = NARROW[dtype]
    rng = np.random.default_rng(2)
    rows, d, n, lr, step = 30, 16, 50, 0.05, 3
    ids = rng.integers(0, rows, n)
    upd, upd_t, _ = values(rng, n, d)
    param, param_t, param_j = values(rng, rows, d)
    states_t, states_j = {}, {}
    for name in _RULES[opt_type][0](param_t, args):
        x, t, j = values(rng, rows, d, scale=0.1)
        if name in ("sum", "v", "sq", "acc", "u"):
            x, t, j = np.abs(x), t.abs(), jnp.abs(j)
        states_t[name], states_j[name] = t, j
    g32 = np.zeros((rows, d), np.float32)
    np.add.at(g32, ids, upd)
    delta, want_states = JAX_RULES[opt_type][1](
        jnp.asarray(g32).astype(dtype), states_j, param_j,
        jnp.float32(lr), jnp.float32(step), dict(args))
    want = (param_j + delta).astype(dtype)
    got_states = fused_sorted_update(opt_type, dict(args), torch.tensor(ids),
                                     upd_t, param_t, states_t, lr, step)
    # one ulp: 2 unit roundoffs of the value, and float16's subnormal
    # spacing 2^-24 (below bfloat16's, 2^-133, the 1e-30 covers)
    tiny = 2.0 ** -24 if dtype == "float16" else 1e-30

    def within_an_ulp(got, want):
        got, want = _np(got), _np(want)
        same_nan = np.isnan(got) & np.isnan(want)  # centered RMSprop's sqrt
        ulp = 2 * unit * np.abs(want) + tiny
        return np.all(same_nan | (np.abs(got - want) <= ulp))

    assert param_t.dtype == tdtype
    assert within_an_ulp(param_t, want)
    for name, value in want_states.items():
        assert got_states[name].dtype == tdtype, name
        assert value.dtype == jnp.dtype(dtype), name
        assert within_an_ulp(got_states[name], value), name


@pytest.mark.parametrize("opt_type,args", FUSED_RULES,
                         ids=[f"{o}{'+' if a else ''}" for o, a in FUSED_RULES])
def test_fused_update_plain_matches_kge_tpu_rule(opt_type, args):
    """K4 on a bfloat16 table and states: the float32 segment sums cast to
    bfloat16, then kge_tpu's rule as its fused kernel applies it (the step
    a float32 array, the result stored in the table's dtype). kge_tpu's
    kernel itself cannot store the rule's float32 result into its bfloat16
    tile (ROADMAP C.4), so its rule runs here on the dense gradient. Within
    one bfloat16 ulp: the two packages' float32 square roots may differ in
    their last bit."""
    _fused_plain_matches_kge_tpu_rule(opt_type, args, "bfloat16")


@pytest.mark.parametrize("opt_type,args", FUSED_RULES,
                         ids=[f"{o}{'+' if a else ''}" for o, a in FUSED_RULES])
def test_fused_update_plain_matches_kge_tpu_rule_in_float16(opt_type, args):
    """K4 on a float16 table and states, as in bfloat16: kge_tpu's rule on
    float16 arrays with the learning rate and the step as float32 arrays
    (its kernel's view; the kernel itself cannot store into a float16 tile,
    ROADMAP C.4). Within one float16 ulp (2^-10 relative, or the subnormal
    spacing 2^-24), NaN where kge_tpu's is NaN: Adagrad's eps 1e-10 rounds
    to 0 in float16 in both packages."""
    _fused_plain_matches_kge_tpu_rule(opt_type, args, "float16")


@pytest.mark.parametrize("kind", ["l1", "cmod"])
def test_pooled_scores_plain_match_kge_tpu(kind):
    """K5a and K5b in bfloat16: scores, dq and dpool in bfloat16 against
    kge_tpu's kernels in interpret mode. The port sums over d (and over the
    rows and candidates of the backward) in float32 and rounds once;
    kge_tpu sums in bfloat16, so the tolerance is 4 bfloat16 ulps of the
    summed magnitudes."""
    _pooled_plain_matches_kge_tpu(kind, 16, 8, 3, 64, seed=3)


@pytest.mark.parametrize("n,K,F,d", [(5, 13, 1, 24), (33, 17, 1, 7), (12, 3, 5, 130)])
@pytest.mark.parametrize("kind", ["l1", "cmod"])
def test_pooled_scores_plain_match_kge_tpu_at_edges(kind, n, K, F, d):
    """The same at the forward kernel's edges (tests/test_torch_dist_pool.py
    ``test_forward_matches_jax_at_edges``): K = 13 and 17, F = 1, d = 7 and
    130, with the same tolerance."""
    _pooled_plain_matches_kge_tpu(kind, n, K, F, d, seed=5)


@pytest.mark.parametrize("kind", ["l1", "cmod"])
def test_pooled_scores_plain_match_kge_tpu_in_float16(kind):
    """K5a and K5b in float16, as in bfloat16: the port sums in float32
    and rounds once, kge_tpu sums in float16, within 4 float16 ulps (2^-11
    relative each) of the summed magnitudes. The inputs have no zero
    distance (tests/test_torch_float16.py has those)."""
    _pooled_plain_matches_kge_tpu(kind, 16, 8, 3, 64, seed=3, dtype="float16")


@pytest.mark.parametrize("n,K,F,d", [(5, 13, 1, 24), (33, 17, 1, 7), (12, 3, 5, 130)])
@pytest.mark.parametrize("kind", ["l1", "cmod"])
def test_pooled_scores_plain_match_kge_tpu_at_edges_in_float16(kind, n, K, F, d):
    """The same at the forward kernel's edges, in float16."""
    _pooled_plain_matches_kge_tpu(kind, n, K, F, d, seed=5, dtype="float16")


def _pooled_plain_matches_kge_tpu(kind, n, K, F, d, seed, dtype="bfloat16"):
    from kge_tpu.ops.dist_pool import pooled_dist_scores as jax_pooled
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores

    unit, values, tdtype = NARROW[dtype]
    rng = np.random.default_rng(seed)
    parts = 1 if kind == "l1" else 2
    qs = [values(rng, n, d) for _ in range(parts)]
    pools = [values(rng, K * F, d) for _ in range(parts)]
    sel = rng.integers(0, F, (n, K))
    g, g_t, g_j = values(rng, n, K)

    def jax_fn(*tensors):
        return jax_pooled(list(tensors[:parts]), list(tensors[parts:]),
                          jnp.asarray(sel, jnp.int32), F, kind)

    want, vjp = jax.vjp(jax_fn, *[q[2] for q in qs], *[p[2] for p in pools])
    want_grads = vjp(g_j)
    tensors = [q[1].clone().requires_grad_(True) for q in qs] + [
        p[1].clone().requires_grad_(True) for p in pools]
    got = pooled_dist_scores(tensors[:parts], tensors[parts:],
                             torch.tensor(sel), F, kind)
    got.backward(g_t)
    assert got.dtype == tdtype and want.dtype == jnp.dtype(dtype)
    rows = np.arange(K)[None, :] * F + sel
    diffs = [q[0][:, None, :] - p[0][rows] for q, p in zip(qs, pools)]
    dist = (np.abs(diffs[0]) if kind == "l1"
            else np.sqrt(diffs[0] ** 2 + diffs[1] ** 2))
    _close_in_bf16(got, want, dist.sum(axis=2), ulps=4, unit=unit)
    # every factor of the backward is at most |g| in magnitude
    dq_mag = np.abs(g).sum(axis=1)[:, None] * np.ones((1, d), np.float32)
    dpool_mag = np.zeros((K * F, d), np.float32)
    np.add.at(dpool_mag, rows.reshape(-1), np.abs(g).reshape(-1, 1) * np.ones(d))
    for i, t in enumerate(tensors):
        assert t.grad.dtype == tdtype
        _close_in_bf16(t.grad, want_grads[i], dq_mag if i < parts else dpool_mag,
                       ulps=4, unit=unit)


# -- evaluation of a bfloat16 model by both packages --------------------------


def _example_ranks(config):
    """The per-example trace entries ``config`` writes from now on."""
    seen = []
    trace = config.trace

    def record(**entry):
        if entry.get("scope") == "example":
            seen.append(entry)
        return trace(**entry)

    config.trace = record
    return seen


def _score_rows(jmodel, params, tmodel, triples, E, dtype=torch.bfloat16):
    """{direction: (kge_tpu's bfloat16 (or ``dtype``) score matrix, the
    port's)}, each [n, E]: the matrices each package ranks (kge_tpu's
    grouped route or its sp_/_po scores; the port's rank-kernel product or
    its score matrix)."""
    from kge_tpu_torch.ops.rank_kernel import chain_scores

    t_triples = torch.tensor(triples)
    j_triples = jnp.asarray(triples, jnp.int32)
    grouped = jmodel.score_all_grouped_multi(params, j_triples, (0, 2))
    fac = tmodel.factorized_queries(t_triples, (0, 2))
    out = {}
    for key, slot in (("o", 2), ("s", 0)):
        if grouped is not None:
            S3 = grouped[slot][1]
            want = np.asarray(S3.reshape(S3.shape[0], -1)[:, :E], np.float32)
        elif slot == 2:
            want = np.asarray(jmodel.score_sp(params, j_triples[:, 0],
                                              j_triples[:, 1]), np.float32)
        else:
            want = np.asarray(jmodel.score_po(params, j_triples[:, 1],
                                              j_triples[:, 2]), np.float32)
        with torch.inference_mode():
            if fac is not None:
                _, q, t, score_map = fac[slot]
                got = chain_scores(q, t[:E])
                got = got if score_map is None else score_map(got)
            elif slot == 2:
                got = tmodel.score_sp(t_triples[:, 0], t_triples[:, 1])
            else:
                got = tmodel.score_po(t_triples[:, 1], t_triples[:, 2])
        assert got.dtype == dtype
        out[key] = (want, got.float().numpy())
    return out


@pytest.mark.parametrize("model", ["complex", "reciprocal_complex", "transe",
                                   "transe_l2"])
def test_evaluation_matches_kge_tpu(synth, model):
    """A bfloat16 model (both dtypes) evaluated by both packages: ranks in
    bfloat16 with the tie test in bfloat16. Per (row, direction), raw and
    filtered ranks are equal where the bfloat16 score row equals
    kge_tpu's bit for bit, and differ by at most the count of differing
    entries elsewhere (kge_tpu's CPU product sums in another order than the
    rank kernel's chain)."""
    from kge_tpu.job import EvaluationJob as JaxEvaluationJob
    from kge_tpu_torch.job import EvaluationJob
    from tests.torch_parity import make_pair, model_options

    name = "transe" if model == "transe_l2" else model
    options = {**model_options(name), **SETTINGS["both"],
               "eval.trace_level": "example", "eval.split": "valid",
               "eval.batch_size": 64}
    if model == "transe_l2":
        options["transe.l_norm"] = 2.0
    jmodel, params, tmodel = make_pair(synth, synth.name, options, seed=5)
    assert tmodel.get_s_embedder().embeddings.dtype == torch.bfloat16
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
                       tmodel.dataset.num_entities())
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
    # most rows agree bit for bit, and there the ranks are equal; L2's
    # augmented operands hold squared norms, bfloat16 sums over d that the
    # two packages reduce in other orders, so its rows differ throughout
    if model != "transe_l2":
        assert equal_rows >= len(triples)
    for metric in ("mean_reciprocal_rank_filtered", "hits_at_10_filtered"):
        assert abs(got[metric] - expected[metric]) <= 0.02, metric


# -- bfloat16 checkpoints across the packages -----------------------------------


def test_port_resumes_kge_tpus_bfloat16_checkpoint(tmp_path):
    """kge_tpu trains the toy config with both dtypes in bfloat16 (on
    ``train.epoch_scan: never``, ROADMAP C.4); the port resumes its initial
    checkpoint (bfloat16 ``ml_dtypes`` leaves, read without that package)
    for the same two epochs: losses within rtol 2e-2, the same leaf dtypes
    in the last checkpoints, and kge_tpu's ``valid`` of the port's folder
    runs. The other direction: tests/test_torch_refusals.py."""
    import shutil
    import sys

    from kge_tpu_torch.models.convert import leaf_tensor
    from kge_tpu_torch.utils.io import load_checkpoint
    from tests.test_torch_cli import EXAMPLES_DIR, _entries, _run, _toy_cwd

    cwd = _toy_cwd(tmp_path)
    jax_run, port = cwd / "kge_tpu", cwd / "port"
    both = ["--parallel.compute_dtype", "bfloat16",
            "--parallel.param_dtype", "bfloat16"]
    _run([sys.executable, "-m", "kge_tpu", "start",
          str(EXAMPLES_DIR / "toy-complex-train.yaml"), *both,
          "--train.epoch_scan", "never", "--train.max_epochs", "2",
          "--valid.every", "0", "--folder", str(jax_run)], cwd=cwd)
    initial = load_checkpoint(str(jax_run / "checkpoint_00000.pt"))
    assert initial["model"][0]["entity_embedder"]["embeddings"].dtype == \
        torch.bfloat16
    port.mkdir()
    for name in ("config.yaml", "checkpoint_00000.pt"):
        shutil.copy(jax_run / name, port / name)
    _run([sys.executable, "-m", "kge_tpu_torch", "resume", str(port),
          "--job.device", "cpu"], cwd=cwd)
    losses = {folder.name: [e["avg_loss"] for e in
                            _entries(folder, event="epoch_completed")]
              for folder in (port, jax_run)}
    assert len(losses["port"]) == 2
    np.testing.assert_allclose(losses["port"], losses["kge_tpu"], rtol=2e-2)
    dtypes = {
        folder.name: {key: leaf_tensor(leaf["embeddings"]).dtype
                      for key, leaf in load_checkpoint(str(
                          folder / "checkpoint_00002.pt"))["model"][0].items()}
        for folder in (port, jax_run)}
    assert dtypes["port"] == dtypes["kge_tpu"]
    _run([sys.executable, "-m", "kge_tpu", "valid", str(port)], cwd=cwd)
