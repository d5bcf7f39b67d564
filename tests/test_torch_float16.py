"""What only float16 has, in kge_tpu_torch against kge_tpu on the CPU
(``parallel.*_dtype: float16``; ROADMAP A.11a). The routes both dtypes
share are in tests/test_torch_dtype_policy.py.

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
  float16 leaves, no stand-in.
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
