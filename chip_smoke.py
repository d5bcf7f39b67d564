"""Smoke run of kge_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every CUDA kernel of the package from ``csrc/`` (one
   ``nvcc`` per source, all started together).
2. The rank kernel (ops/rank_kernel.py) against its plain PyTorch version on
   the card at n = 256, 1,024 and 242 (the last test batch), |E| = 14,541,
   D = 512, and at D = 510 (no multiple of 4: the 4-byte copy route), with
   skewed CSR labels and NaN / -inf edge rows. Label values agree within
   rtol 1e-5 (atol 1e-6); counts agree on every row except rows where a
   candidate's plain score lies within 4 ulp of a tie boundary pivot +-
   (atol + rtol |pivot|), since cuBLAS sums in another order than the
   kernel. The rows that differ there are excluded, counted, and may be at
   most 0.1% of the rows; the rows at a boundary are counted too. The
   kernel's four outputs are bit-equal across two launches and across three
   column splits (the planned one, one range, one wave of blocks), and the
   label value at the pivot column equals the pivot bit for bit.
3. The main path: a synthetic dataset of FB15k-237's sizes (14,541
   entities, 237 relations, 272,115 / 17,535 / 20,466 triples, made from
   ``--seed``), reciprocal ComplEx at d = 512 (the repo's
   examples/fb15k-237-complex-1vsall.yaml) with random weights made with
   numpy, carried across with ``load_jax_params`` and saved as a checkpoint
   in kge_tpu's schema, then ``python -m kge_tpu_torch test <folder>
   --eval.batch_size 256`` run in this process through ``cli.main``. The
   rank kernel's launch counter must have moved; every batch's filtered
   ranks must equal those of the plain version under the rule of phase 2;
   the metrics must be finite; and a small evaluation on the card must
   report the same metrics as on the CPU.
4. Where the eval's time goes (a profiled warm evaluation) and the rank
   kernel's time per call beside its plain version, one library call and
   its bound, at the evaluation's first batch, at n = 1,024 and over
   200,000 candidates, each also as one wave of blocks.
5. The scatter kernel (ops/embedding_ops.py ``sorted_scatter_add``) against
   its plain version in float64 at the shapes of a training step (8,192
   updates into 14,541 entity rows and into 237 relation rows, 129 updates
   into 14,541 rows, all at D = 512), at a mini-table shape (``arange`` ids)
   and with every id equal. A sum of float32 in another order than the
   reference's differs by rounding that grows with the summed magnitudes,
   so the check is ``|kernel - reference| <= 1e-6 + 1e-5 S`` with S the
   row's sum of ``|update|`` (for a row of one update that is rtol 1e-5,
   atol 1e-6); two launches must give the same bits. The kernel's own sort
   (launch A: sorted ids, permutation and segment numbers) must equal a
   stable ``torch.sort`` exactly at every one of these cases, at n = 1, at
   the largest n it takes and, through the wrapper's ``torch.sort`` route,
   at one above; the segment sums built on it are held to the same float64
   rule. The row-write kernel
   (``rows_set``) against its plain version: exact equality with duplicate
   ids, at 16,642 rows into a 200,000-row table and 8,192 rows into a
   237-row table, and the table keeps its storage.
6. Training, dense step (T-dense): ``python -m kge_tpu_torch start`` through
   ``cli.main`` on the synthetic FB15k-237-sized graph: ComplEx d = 512,
   128 shared negatives per corrupted slot, KL loss, Adagrad lr 0.1, batch
   8,192 (34 batches an epoch), two epochs and one validation through the
   rank kernel, then ``resume`` to epoch 3. The scatter kernel's counter
   must equal 5 launches a step (the lookups of s, p, o and one target list
   per corrupted slot), the rank kernel's two a validation batch; the loss
   must be finite and fall; the resumed job must start at epoch 3 from the
   Adagrad ``sum`` it saved. One step with the kernel against the same step
   with ``train.pallas_gather: never`` (torch's indexing backward) from the
   same state and negatives: tables within atol 1e-6 + rtol 1e-5.
7. Training, row-sparse step (T-sparse): the same triple counts over 200,000
   entities, where ``train.sparse_embedding_update: auto`` engages; one
   epoch through ``cli.main``. The row-write kernel's counter must equal 4
   a step (parameter and ``sum``, entity and relation table), the scatter
   kernel's 7 (five lookups on the mini-tables, two segment sums). One
   sparse step against the dense step from the same state and negatives:
   touched rows within atol 1e-6 + rtol 1e-5, untouched rows bit-equal.
8. Timings: the two kernels per call at the main shapes beside plain,
   library (``index_add_``, ``index_copy_``) and bound, the scatter
   kernel's two launches (sort and zeros; sums) also alone, at d = 128 and
   at the row-sparse step's 16,642 ids of 200,000 too, with the segment
   sums and their sort alone; a warm epoch of
   each training configuration (wall, triples/s) and a profile of it with
   the device's busy share.
9. The fused row-update kernel (ops/optim.py ``fused_sorted_update``)
   against its plain version in float64 at [200,000, 1,024] with 10,240
   row gradients and at [237, 512] with 4,096 (over 94% duplicates): Adam,
   AdamW and Adagrad with weight decay and SGD with Nesterov momentum at
   both shapes, every other rule at the small one, from random non-zero
   states at step 3 (and step 0 for SGD's momentum), on row gradients whose
   duplicates agree in sign (no sum cancels). Parameter and states
   within ``1e-6 + 1e-5 |reference|`` on every row; Adam's moments of
   untouched rows bit-equal to ``beta * moment``; storage kept; two launches
   from the same state bit-equal.
10. The pooled distance kernels (ops/dist_pool.py ``pooled_dist_scores``
   and its backward) against the plain version in float64, for ``l1``
   (n = 8,192, K = 128, F = 8, d = 128 and d = 512) and ``cmod`` (n = 4,096,
   K = 128, F = 8, d = 512 per part), one odd shape (n = 37, K = 5, F = 3,
   d = 100, and d = 51 for the scalar path) and rows whose query equals a
   candidate: scores, dq and dpool within ``1e-6 + 1e-5 S`` with S the sum of
   the magnitudes that the element adds up; two launches bit-equal.
11. P-transe: ``start`` through ``cli.main``, TransE-L1 d = 128, margin
   ranking 4.0, 128 negatives per corrupted slot, ``implementation: auto``
   (must resolve to ``pool``), Adagrad lr 0.1, batch 8,192, FB15k-237 sizes,
   two epochs without validation, then ``resume`` to a third. Dense step:
   per step 2 launches of the pooled forward, 2 of its backward and 12 of
   the scatter kernel (per corrupted slot the lookups of s, p, o, of the
   two kept slots again and of the pool); the loss is finite and falls.
12. P-rotate: RotatE-L1 d = 1,024, self-adversarial BCE, Adam lr 0.001,
   batch 4,096, 128 negatives per slot, pool factor 8, over the
   200,000-entity graph: one epoch through ``cli.main`` and a ``resume``
   from its checkpoint. The log must say that the row-sparse step engaged
   with the fused kernel; per step 2 launches of the fused update, none of
   the row write, 2 + 2 of the pooled kernels and 14 of the scatter kernel
   (12 lookups on the mini-tables, 2 segment sums); the loss is finite and
   falls; Adam's ``m`` and ``v`` come back from the checkpoint. One sparse
   step against one dense step from the same state, pool and ``sel``:
   tables and moments of every row within ``1e-6 + 1e-5 |dense|``, except
   that at most 1e-5 of the elements may differ by up to 2.1 lr: where a
   row's gradient nearly cancels, two summation orders give gradients of
   different sign, and Adam's ``m_hat / (sqrt(v_hat) + eps)`` turns both
   into about +-lr.
13. Timings at P-rotate's shapes: the three new kernels per call beside
   plain, a library route (``index_add_`` and ``torch.optim.Adam(fused=
   True)``; ``cdist(p=1)`` and a gather for ``l1``, none for ``cmod``) and
   the bound; the pooled scoring's two routes (kernel, one-hot select) at
   d = 128; a warm epoch of each new configuration with its profile.
14. T-transe-l2: TransE-L2 d = 128 with the settings of
   examples/fb15k-237-transe-negsamp.yaml (margin ranking 4.0, Adagrad lr
   0.05, batch 2,048, 64 + 64 negatives, ``xavier_uniform_``; ``auto``
   must resolve to ``pool``, whose pool L2 scores once through its
   factorization, every row picking its columns) on the
   FB15k-237-sized graph: ``start`` for two epochs with ``valid.every 1``,
   then ``test`` on the folder. Both validations must run,
   ``checkpoint_00002.pt`` must exist and the loss must fall; the rank
   kernel must launch twice a validation and a test batch, every launch
   with the L2 score epilogue. Every test batch's filtered ranks must equal
   the plain version's outside tie-boundary rows (phase 3's rule, with the
   boundary window widened by the augmented product's rounding). The
   epilogue kernel against its plain version on random inputs at n = 256,
   |E| = 14,541, d = 128 (132 augmented columns), close pairs included:
   counts equal outside tie-boundary rows, label values and pivots within
   rtol 1e-5 (atol 1e-6), and the epilogue applied to the identity
   kernel's pivots and label values gives the epilogue kernel's bits. Its
   time per call beside the plain version, ``matmul`` + the epilogue +
   compares and the bound (2 n |E| D' fp32 operations). Walls, and the
   profiles of a warm epoch and of a warm test evaluation. Then ``test`` on
   phase 11's P-transe folder (TransE-L1: the score-matrix route, no rank kernel
   launch) must exit with finite metrics; its warm evaluation is
   profiled.
15. One ``kernels`` JSON line: per kernel its time per call at the main
   path's shape, launches on its main path, the plain version's and one
   library call's time, and the bound (bytes over 3.35 TB/s or fp32
   operations over 67 TFLOP/s, whichever is larger); every time in it is
   measured by this run; the rank kernel's entry also holds the L2
   epilogue's times and its launches in phase 14. Then the card's name
   and power limit, then the ``ok`` JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import time
import uuid
from concurrent.futures import ThreadPoolExecutor

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, fp32 outside tensor cores
ATOL, RTOL = 1e-5, 1e-4        # entity_ranking.tie_handling defaults
SPIN_CYCLES = 90_000_000       # about 50 ms of an H100's clock

# FB15k-237: entities, relations, train / valid / test triples
FB15K237 = (14541, 237, 272115, 17535, 20466)
NUM_ENTITIES, NUM_TEST = FB15K237[0], FB15K237[4]
DIM, BATCH = 512, 256
KERNELS = ("rank_counts", "scatter_add_sorted", "rows_set", "fused_row_update",
           "dist_pool")
# training: bench.py's headline workload
TRAIN_BATCH, NUM_NEGATIVES, SPARSE_ENTITIES = 8192, 128, 200000
# pooled negatives: bench.py's transe_margin and rotate_selfadv workloads
POOL_FACTOR, TRANSE_DIM, ROTATE_DIM, ROTATE_BATCH = 8, 128, 1024, 4096
ROTATE_LR = 0.001
ROOT = os.path.dirname(os.path.abspath(__file__))
WORK = os.path.join(ROOT, "build", "chip_smoke")


def log(*args):
    print(*args, flush=True)


def check(condition, message="check failed") -> None:
    """Fail the run (an assert would vanish under python -O)."""
    if not condition:
        raise RuntimeError(f"chip_smoke.py: {message}")


def card_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip()


def time_ms(fn, reps: int = 30) -> float:
    """Mean device time of ``fn`` by CUDA events, after a warm-up. The
    timed launches are queued behind a spin kernel of about 50 ms, so that
    the device runs them back to back and the host's enqueue rate (which
    varies between machines) does not set the reading."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


# -- the rank kernel against its plain version ---------------------------------


def boundary_rows(q, targets, pivot, num_valid, score_map=None,
                  dim=None) -> torch.Tensor:
    """Rows where a plain score lies within 4 ulp of pivot +- tolerance:
    there the kernel's summation order may legitimately flip a decision.
    With the L2 epilogue (``score_map``; q and targets the augmented
    operands of a ``dim``-wide embedding) a row is also near where the
    product lies within 32 float32 epsilons of (||q|| + ||c||)^2, the
    rounding of a cancelling sum, from a bound's preimage -b^2."""
    dots = q @ targets[:num_valid].T
    scores = dots if score_map is None else score_map(dots)
    p = torch.where(torch.isnan(pivot), torch.full_like(pivot, -float("inf")), pivot)
    tol = ATOL + RTOL * p.abs()
    near = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    if score_map is not None:
        qn = (-q[:, dim + 1]).clamp_min(0).sqrt()
        cn = targets[:num_valid, dim].clamp_min(0).sqrt()
        window = 32 * 1.1920929e-07 * (qn[:, None] + cn[None, :]) ** 2
    for bound in (p - tol, p + tol):
        b = bound[:, None]
        ulp = (torch.nextafter(b.abs(), torch.full_like(b, float("inf")))
               - b.abs())
        close = (scores - b).abs() <= 4 * ulp
        if score_map is not None:
            close |= (dots + b * b).abs() <= window
        near |= (close & torch.isfinite(b)).any(dim=1)
    return near


def skewed_labels(rng, n, num_entities, device, true=None):
    """CSR labels with FB15k-237-like skew: most rows hold a few labels,
    every 37th row thousands. With ``true``, row i also holds true[i], as
    an evaluation's labels hold the true answer."""
    per_row = []
    for i in range(n):
        k = 3000 if i % 37 == 1 else int(rng.zipf(1.6)) % 200
        row = rng.choice(num_entities, size=k, replace=False)
        if true is not None:
            row = np.union1d(row, true[i:i + 1])
        per_row.append(np.sort(row))
    row_ptr = np.concatenate([[0], np.cumsum([len(c) for c in per_row])])
    return (torch.tensor(row_ptr, dtype=torch.int32, device=device),
            torch.tensor(np.concatenate(per_row), dtype=torch.int32, device=device))


def compare_kernel(seed: int, device):
    """Phase 2; returns (max |vals error|, rows excluded, rows)."""
    from kge_tpu_torch.ops.rank_kernel import (
        csr_row_ids,
        fused_rank_counts,
        fused_rank_counts_plain,
        rank_plan,
    )

    rng = np.random.default_rng(seed)
    E = NUM_ENTITIES
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    max_err, excluded, rows = 0.0, 0, 0
    tables = {}
    for n, D in ((256, DIM), (1024, DIM), (242, DIM), (242, DIM - 2)):
        if D not in tables:
            tables[D] = torch.tensor(
                rng.normal(0, 0.05, (E, D)).astype(np.float32), device=device)
        targets = tables[D]
        t0 = targets[:, 0].cpu().numpy()
        true_np = rng.integers(0, E, n).astype(np.int32)
        qn = rng.normal(0, 0.05, (n, D)).astype(np.float32)
        qn[2] = np.nan                          # NaN pivot, reads as -inf
        for row, sign in ((5, -1.0), (6, 1.0)):  # -inf and +inf pivots
            qn[row] = 0.0
            qn[row, 0] = sign * np.inf * np.sign(t0[true_np[row]])
        q = torch.tensor(qn, device=device)
        row_ptr, cols = skewed_labels(rng, n, E, device, true=true_np)
        true = torch.tensor(true_np, device=device)

        def run(plan=None):
            out = fused_rank_counts(q, targets, None, row_ptr, cols, E, ATOL, RTOL,
                                    pivot_cols=true, plan=plan)
            torch.cuda.synchronize()
            return out

        g, c, vals, pivot = first = run()
        check(bool(torch.isnan(pivot[2])) and float(pivot[5]) == -float("inf")
              and float(pivot[6]) == float("inf"),
              "edge rows did not give NaN, -inf and +inf pivots")

        def same_bits(a, b):
            return all(torch.equal(x.view(torch.int32), y.view(torch.int32))
                       for x, y in zip(a, b))

        planned = rank_plan(n, E)
        for what, plan in (
            ("a second launch", None),
            ("one column range", rank_plan(n, E, num_ranges=1)),
            ("one wave of blocks",
             rank_plan(n, E, num_ranges=2 * sms // planned["row_tiles"])),
        ):
            check(same_bits(first, run(plan)),
                  f"rank kernel outputs differ in bits with {what} (n={n}, D={D})")
        at_pivot = cols == true[csr_row_ids(row_ptr)]
        check(int(at_pivot.sum()) == n and torch.equal(
            vals[at_pivot].view(torch.int32), pivot.view(torch.int32)),
            f"the label value at the pivot column is not the pivot's bits (n={n})")
        pg, pc, pvals, _ = fused_rank_counts_plain(
            q, targets, pivot, row_ptr, cols, E, ATOL, RTOL
        )
        both_nan = torch.isnan(vals) & torch.isnan(pvals)
        err = torch.where(both_nan, torch.zeros_like(vals), (vals - pvals).abs())
        finite_ref = torch.isfinite(pvals)
        ok_vals = bool(torch.all(
            both_nan | (vals == pvals)
            | (finite_ref & (err <= 1e-6 + 1e-5 * pvals.abs()))
        ))
        check(ok_vals, f"rank kernel vals disagree with plain (n={n}, D={D})")
        max_err = max(max_err, float(err[finite_ref].max()) if finite_ref.any() else 0.0)
        differ = (g != pg) | (c != pc)
        near = boundary_rows(q, targets, pivot, E)
        bad = differ & ~near
        check(not bool(bad.any()), (
            f"rank kernel counts disagree with plain on {int(bad.sum())} "
            f"rows away from a tie boundary (n={n}, D={D})"
        ))
        excluded += int((differ & near).sum())
        rows += n
        log(f"  n={n} D={D}: counts equal on {n - int(differ.sum())}/{n} rows; "
            f"{int(near.sum())} rows lie at a tie boundary, "
            f"{int((differ & near).sum())} of them differ and are excluded; "
            f"vals max abs err {float(err[finite_ref].max()):.3e}; outputs "
            f"bit-equal across two launches, {planned['num_ranges']} / 1 / "
            f"{2 * sms // planned['row_tiles']} column ranges; the "
            f"label value at the pivot column is the pivot bit for bit")
    check(excluded <= 0.001 * rows, f"{excluded} of {rows} rows excluded")
    return max_err, excluded, rows


# -- the main path -------------------------------------------------------------


def write_dataset(folder: str, seed: int, sizes=FB15K237):
    """Synthetic triples of the given sizes (default FB15k-237's); entities
    and relations are drawn with power-law popularity so that some queries
    hold many answers, as in the real graph."""
    num_entities, num_relations, num_train, num_valid, num_test = sizes
    rng = np.random.default_rng(seed)
    os.makedirs(folder, exist_ok=True)

    def popularity(k, a):
        w = 1.0 / np.arange(1, k + 1) ** a
        return rng.permutation(w / w.sum())

    pe = popularity(num_entities, 0.8)
    pr = popularity(num_relations, 1.0)
    total = num_train + num_valid + num_test
    triples = np.stack([
        rng.choice(num_entities, total, p=pe),
        rng.choice(num_relations, total, p=pr),
        rng.choice(num_entities, total, p=pe),
    ], axis=1)
    triples[:num_entities, 0] = np.arange(num_entities)
    triples[:num_relations, 1] = np.arange(num_relations)
    splits = {
        "train": triples[:num_train],
        "valid": triples[num_train:num_train + num_valid],
        "test": triples[num_train + num_valid:],
    }
    for name, arr in splits.items():
        with open(os.path.join(folder, f"{name}.del"), "w") as f:
            f.write("\n".join("\t".join(map(str, t)) for t in arr.tolist()) + "\n")
    for name, num in (("entity_ids", num_entities), ("relation_ids", num_relations)):
        with open(os.path.join(folder, f"{name}.del"), "w") as f:
            f.write("".join(f"{i}\t{name[0]}{i}\n" for i in range(num)))
    with open(os.path.join(folder, "dataset.yaml"), "w") as f:
        f.write(f"dataset:\n  name: {os.path.basename(folder)}\n"
                f"  num_entities: {num_entities}\n  num_relations: {num_relations}\n")


def write_checkpoint(folder: str, data: str, seed: int, device: str, dim: int,
                     batch_size: int):
    """A kge_tpu-schema experiment folder (config.yaml + checkpoint_best.pt)
    holding reciprocal ComplEx with random numpy weights."""
    from kge_tpu_torch import Config, Dataset
    from kge_tpu_torch.models import KgeModel, load_jax_params, to_jax_params
    from kge_tpu_torch.utils.io import save_checkpoint

    config = Config()
    config.load_options({
        "model": "reciprocal_relations_model",
        "reciprocal_relations_model.base_model.type": "complex",
    })
    config.set("lookup_embedder.dim", dim)
    config.set("job.device", device)
    config.set("dataset.name", data)
    config.set("eval.batch_size", batch_size)
    config.set("random_seed.default", seed)
    config.set("console.quiet", True)
    config.folder = folder
    if os.path.exists(folder):
        import shutil

        shutil.rmtree(folder)
    config.init_folder()
    dataset = Dataset.create(config)
    rng = np.random.default_rng(seed + 1)
    E, R = dataset.num_entities(), dataset.num_relations()
    params = {
        "entity_embedder": {"embeddings": rng.normal(0, 0.1, (E, dim)).astype(np.float32)},
        "relation_embedder": {"embeddings": rng.normal(0, 0.1, (2 * R, dim)).astype(np.float32)},
    }
    model = KgeModel.create(config, dataset, init_for_load_only=True,
                            device=torch.device("cpu"))
    load_jax_params(model, params)
    checkpoint = {
        "type": "train", "epoch": 0, "valid_trace": [],
        "model": (to_jax_params(model), {}), "optimizer_state": None,
        "lr_scheduler_state_dict": {}, "job_id": str(uuid.uuid4()),
    }
    config.save_to(checkpoint)
    dataset.save_to(checkpoint)
    save_checkpoint(checkpoint, config.checkpoint_file("best"))
    return config.checkpoint_file("best")


def test_job(folder: str):
    """An evaluation job on the test split of the experiment ``folder``,
    as the ``test`` verb builds it."""
    from kge_tpu_torch import Config
    from kge_tpu_torch.job import EvaluationJob
    from kge_tpu_torch.utils.io import load_checkpoint

    config = Config()
    config.load(os.path.join(folder, "config.yaml"))
    config.folder = folder
    config.set("eval.split", "test")
    return EvaluationJob.create_from(
        load_checkpoint(Config.best_or_last_checkpoint_file(folder)),
        new_config=config,
    )


def last_test_entry(folder: str):
    import yaml

    entry = None
    with open(os.path.join(folder, "trace.yaml")) as f:
        for line in f:
            e = yaml.safe_load(line)
            if e.get("event") == "eval_completed" and e.get("split") == "test":
                entry = e
    check(entry is not None, "no eval trace entry")
    return entry


def profile_run(fn, what: str):
    """``fn()`` under torch.profiler: wall time, device time by kernel
    name, and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - start) * 1e3

    def device_us(event):
        return getattr(event, "self_device_time_total",
                       getattr(event, "self_cuda_time_total", 0.0))

    # kernels only: an operator's entry repeats its kernels' device time
    events = [e for e in prof.key_averages()
              if str(getattr(e, "device_type", "")).endswith("CUDA")
              and device_us(e) > 0]
    busy_ms = sum(device_us(e) for e in events) / 1e3
    ranked = sorted(events, key=device_us, reverse=True)

    def rows(chosen):
        return [{"name": e.key[:60], "ms": device_us(e) / 1e3, "calls": e.count}
                for e in chosen]

    # the six longest, and the package's own kernels (all compiled into
    # anonymous namespaces) and torch's sorts wherever they rank
    top = rows(ranked[:6])
    own = rows(e for e in ranked[6:]
               if "(anonymous namespace)::" in e.key and "at::native" not in e.key)
    sorts = rows(e for e in ranked if "RadixSort" in e.key or "radix_sort" in e.key)
    out = {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if events else None,
        "device_busy_share": busy_ms / wall_ms if events else None,
        "top": top, "own_kernels_below_top": own, "torch_sort_kernels": sorts,
    }
    if not events:
        log("  profiler recorded no device time: not measured")
    else:
        log(f"  profiled {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
            f"({100 * busy_ms / wall_ms:.1f}%)")
        for t in top + own:
            log(f"    {t['ms']:9.3f} ms  {t['calls']:5d} calls  {t['name']}")
        log(f"    torch radix-sort kernels: {sum(t['calls'] for t in sorts)} launches, "
            f"{sum(t['ms'] for t in sorts):.3f} ms")
    return out


def eval_ranks_agree(job, dim=None):
    """Every batch of a prepared evaluation job (its collated batches) ranked
    by the kernel and by its plain version: filtered ranks equal outside the
    tie-boundary rows, which may be at most 0.1% of the (row, ranking,
    direction) entries. ``dim``: the embedding width, for the L2
    epilogue's boundary window."""
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts_plain

    _, device_batches = job._collate_cache
    E = job.dataset.num_entities()
    differ_rows = near_rows = total_rows = 0
    for triples, labels in device_batches:
        kernel, _ = job._rank_batch(triples, labels)
        plain, _ = job._rank_batch(triples, labels,
                                   rank_counts=fused_rank_counts_plain)
        fac = job.model.factorized_queries(triples, (0, 2))
        near = {}
        for key, slot, true in (("o", 2, triples[:, 2]), ("s", 0, triples[:, 0])):
            _, q, targets, score_map = fac[slot]
            pivot = fused_rank_counts_plain(
                q, targets, None, labels[key][0], labels[key][1],
                E, ATOL, RTOL, score_map=score_map, pivot_cols=true,
            )[3]
            near[key] = boundary_rows(q, targets, pivot, E, score_map, dim)
        for r in kernel:
            d = kernel[r] != plain[r]
            d_s, d_o = d[0] | d[1], d[2] | d[3]
            bad = (d_s & ~near["s"]) | (d_o & ~near["o"])
            check(not bool(bad.any()), f"ranking {r}: kernel and plain ranks differ")
            differ_rows += int(d_s.sum() + d_o.sum())
            near_rows += int(near["s"].sum() + near["o"].sum())
            total_rows += 2 * triples.shape[0]
    check(differ_rows <= 0.001 * total_rows, (differ_rows, total_rows))
    log(f"  filtered ranks of all {len(device_batches)} batches equal the plain "
        f"version's on {total_rows - differ_rows}/{total_rows} (row, ranking, "
        f"direction) entries; {near_rows} lie at a tie boundary, the "
        f"{differ_rows} that differ are excluded")
    return {"entries": total_rows, "at_boundary": near_rows, "differ": differ_rows}


def small_eval_agrees(seed: int):
    """A small evaluation on the card and on the CPU reports the same
    metrics (the CPU runs the plain versions)."""
    data = os.path.join(WORK, "small_data")
    write_dataset(data, seed, sizes=(500, 8, 5000, 300, 300))
    entries = {}
    for device in ("cuda", "cpu"):
        folder = os.path.join(WORK, f"small_{device}")
        write_checkpoint(folder, data, seed, device, 32, 64)
        entries[device] = test_job(folder).run()
    keys = [k for k in entries["cpu"]
            if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
            and not k.endswith("_with_test")]
    differ = [k for k in keys if entries["cuda"][k] != entries["cpu"][k]]
    check(keys and not differ, f"card and CPU metrics differ: {differ}")
    log(f"  small eval (500 entities, d=32): {len(keys)} metrics equal on card and CPU")


# -- the scatter and row-write kernels against their plain versions ------------


def power_law_ids(rng, vocab: int, n: int, exponent: float) -> np.ndarray:
    """n ids with power-law popularity, as the synthetic graph's."""
    w = 1.0 / np.arange(1, vocab + 1) ** exponent
    return rng.choice(vocab, n, p=rng.permutation(w / w.sum()))


def scatter_cases(rng):
    """(name, ids, num_rows): the three scatter shapes of a dense training
    step, a mini-table shape and a hot row."""
    n, E, R = TRAIN_BATCH, NUM_ENTITIES, FB15K237[1]
    return [
        ("entity lookups", power_law_ids(rng, E, n, 0.8), E),
        ("relation lookups", power_law_ids(rng, R, n, 1.0), R),
        ("shared targets", rng.integers(0, E, NUM_NEGATIVES + 1), E),
        ("mini-table (arange ids)", np.arange(n), 2 * n + 2 * (NUM_NEGATIVES + 1)),
        ("hot row (all ids equal)", np.full(n, 7), R),
    ]


def rows_set_cases(rng):
    """(name, num_rows, ids): the two row writes of a row-sparse step, into
    the entity table (s, o and both target lists) and the relation table."""
    m_entity = 2 * TRAIN_BATCH + 2 * (NUM_NEGATIVES + 1)
    return [
        ("entity table", SPARSE_ENTITIES,
         power_law_ids(rng, SPARSE_ENTITIES, m_entity, 0.8)),
        ("relation table", FB15K237[1],
         power_law_ids(rng, FB15K237[1], TRAIN_BATCH, 1.0)),
    ]


def stable_sort_reference(ids, num_rows):
    """(sorted keys, permutation, segment numbers) of a stable torch.sort,
    ids outside the table read as ``num_rows``."""
    outside = (ids < 0) | (ids >= num_rows)
    keys, order = torch.sort(
        torch.where(outside, torch.full_like(ids, num_rows), ids), stable=True)
    first = torch.ones_like(keys, dtype=torch.bool)
    first[1:] = keys[1:] != keys[:-1]
    return keys, order, torch.cumsum(first, 0) - 1


def check_sort_and_segments(name, ids, upd, num_rows):
    """Launch A's sort against a stable torch.sort, exactly, and the segment
    sums built on it against float64."""
    from kge_tpu_torch.ops.embedding_ops import scatter_launch, sorted_segment_sums

    n = ids.shape[0]
    keys, order, seg = stable_sort_reference(ids, num_rows)
    _, work, _ = scatter_launch(ids, None, upd, num_rows, phases=1)
    rs, got_seg, gsum = sorted_segment_sums(ids, upd, num_rows)
    torch.cuda.synchronize()
    check(torch.equal(work[:n].long(), keys) and torch.equal(work[n:2 * n].long(), order)
          and torch.equal(work[2 * n:3 * n].long(), seg),
          f"the kernel's sort differs from a stable torch.sort ({name})")
    check(torch.equal(rs.long(), keys) and torch.equal(got_seg.long(), seg),
          f"segment numbers differ from a stable torch.sort's ({name})")
    ref = torch.zeros(n, upd.shape[1], dtype=torch.float64, device=ids.device)
    magnitude = torch.zeros_like(ref)
    ref.index_add_(0, seg, upd.double()[order])
    magnitude.index_add_(0, seg, upd.double().abs()[order])
    check(bool(((gsum.double() - ref).abs() <= 1e-6 + 1e-5 * magnitude).all()),
          f"segment sums disagree with float64 ({name})")


def compare_scatter(seed: int, device) -> float:
    """Phase 5, scatter kernel; returns the largest |error| at the three
    shapes of the dense step."""
    from kge_tpu_torch.ops.embedding_ops import (
        SORT_LIMIT,
        sort_route,
        sorted_scatter_add,
        sorted_scatter_add_plain,
    )

    rng = np.random.default_rng(seed + 2)
    worst = 0.0
    cases = scatter_cases(rng) + [
        ("one update", np.array([NUM_ENTITIES - 1]), NUM_ENTITIES),
        ("the largest sort in the kernel",
         power_law_ids(rng, SPARSE_ENTITIES, SORT_LIMIT, 0.8), SPARSE_ENTITIES),
        ("one above it (torch.sort route)",
         power_law_ids(rng, SPARSE_ENTITIES, SORT_LIMIT + 1, 0.8), SPARSE_ENTITIES),
    ]
    for index, (name, ids_np, num_rows) in enumerate(cases):
        D = DIM if index < 5 else 64
        ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
        upd = torch.tensor(
            rng.normal(0, 1, (len(ids_np), D)).astype(np.float32), device=device)
        before = sorted_scatter_add.launches, sorted_scatter_add.torch_sorts
        got = sorted_scatter_add(ids, upd, num_rows)
        again = sorted_scatter_add(ids, upd, num_rows)
        torch.cuda.synchronize()
        by_torch = sort_route(len(ids_np)) == "torch"
        check(by_torch == (len(ids_np) > SORT_LIMIT))
        check(sorted_scatter_add.launches == before[0] + 2, "scatter launches not counted")
        check(sorted_scatter_add.torch_sorts == before[1] + 2 * by_torch,
              f"the sort took another route than sort_route says ({name})")
        check(got.shape == (num_rows, D) and got.dtype == torch.float32)
        check(torch.equal(got, again), f"scatter kernel not deterministic ({name})")
        ref = sorted_scatter_add_plain(ids, upd.double(), num_rows)
        magnitude = sorted_scatter_add_plain(ids, upd.double().abs(), num_rows)
        err = (got.double() - ref).abs()
        check(bool((err <= 1e-6 + 1e-5 * magnitude).all()),
              f"scatter kernel disagrees with its plain version ({name})")
        if not by_torch:
            check_sort_and_segments(name, ids, upd, num_rows)
        strict = float((err <= 1e-6 + 1e-5 * ref.abs()).double().mean())
        counts = torch.bincount(ids, minlength=num_rows)
        log(f"  {name}: n={len(ids_np)} rows={num_rows}, longest segment "
            f"{int(counts.max())}, {int((counts == 0).sum())} empty rows: bit-equal "
            f"across two launches, max abs err {float(err.max()):.3e} "
            f"({100 * strict:.4f}% of elements also within 1e-6 + 1e-5 |ref|); "
            + ("sorted by torch.sort in the wrapper" if by_torch else
               "sort, permutation and segment numbers equal a stable torch.sort's, "
               "segment sums within tolerance"))
        if index < 3:
            worst = max(worst, float(err.max()))
    return worst


def compare_rows_set(seed: int, device) -> float:
    """Phase 5, row-write kernel: exact, in place, with duplicate ids."""
    from kge_tpu_torch.ops.embedding_ops import rows_set, rows_set_plain

    rng = np.random.default_rng(seed + 3)
    worst = 0.0
    for name, num_rows, ids_np in rows_set_cases(rng):
        table = torch.tensor(
            rng.normal(0, 1, (num_rows, DIM)).astype(np.float32), device=device)
        # one value per distinct row, repeated for duplicates
        values = torch.tensor(
            rng.normal(0, 1, (num_rows, DIM)).astype(np.float32), device=device)
        ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
        rows = values[ids]
        want = rows_set_plain(table.clone(), ids, rows)
        ptr, before = table.data_ptr(), rows_set.launches
        out = rows_set(table, ids, rows)
        torch.cuda.synchronize()
        check(rows_set.launches == before + 1, "row-write launches not counted")
        check(out is table and table.data_ptr() == ptr, "rows_set copied the table")
        check(torch.equal(table, want), f"rows_set differs from its plain version ({name})")
        worst = max(worst, float((table - want).abs().max()))
        duplicates = len(ids_np) - len(np.unique(ids_np))
        log(f"  rows_set {name}: m={len(ids_np)} into [{num_rows}, {DIM}], "
            f"{100 * duplicates / len(ids_np):.1f}% duplicate ids: equal to the "
            f"plain version, storage unchanged")
    return worst


# -- training through the command line ------------------------------------------


def write_train_config(path: str, data: str, seed: int, **extra):
    """bench.py's headline workload as a config file: ComplEx d = 512, 128
    shared negatives per corrupted slot, KL loss, Adagrad lr 0.1, batch
    8,192."""
    import yaml

    options = {
        "job": {"type": "train", "device": "auto"},
        "dataset": {"name": data},
        "model": "complex",
        "lookup_embedder": {"dim": DIM},
        "train": {
            "type": "negative_sampling", "batch_size": TRAIN_BATCH, "loss": "kl",
            "max_epochs": 2,
            "optimizer": {"default": {"type": "Adagrad", "args": {"lr": 0.1}}},
        },
        "negative_sampling": {
            "shared": True, "shared_type": "default", "implementation": "auto",
            "num_samples": {"s": NUM_NEGATIVES, "p": 0, "o": -1},
        },
        "valid": {"every": 2},
        "eval": {"batch_size": BATCH},
        "random_seed": {"default": seed},
        "console": {"quiet": True},
    }
    for key, value in extra.items():
        node = options
        parts = key.split(".")
        for part in parts[:-1]:
            node = node.setdefault(part, {})
        node[parts[-1]] = value
    with open(path, "w") as f:
        yaml.safe_dump(options, f)


def trace_entries(folder: str, **match):
    import yaml

    out = []
    with open(os.path.join(folder, "trace.yaml")) as f:
        for line in f:
            entry = yaml.safe_load(line)
            if all(entry.get(k) == v for k, v in match.items()):
                out.append(entry)
    return out


def reset_counters():
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores
    from kge_tpu_torch.ops.embedding_ops import rows_set, sorted_scatter_add
    from kge_tpu_torch.ops.optim import fused_sorted_update
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

    fused_rank_counts.launches = 0
    fused_rank_counts.epilogue_launches = 0
    sorted_scatter_add.launches = 0
    rows_set.launches = 0
    fused_sorted_update.launches = 0
    pooled_dist_scores.launches = 0
    pooled_dist_scores.backward_launches = 0


def read_counters():
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores
    from kge_tpu_torch.ops.embedding_ops import rows_set, sorted_scatter_add
    from kge_tpu_torch.ops.optim import fused_sorted_update
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

    return {"rank_counts": fused_rank_counts.launches,
            "rank_counts_epilogue": fused_rank_counts.epilogue_launches,
            "scatter_add_sorted": sorted_scatter_add.launches,
            "rows_set": rows_set.launches,
            "fused_row_update": fused_sorted_update.launches,
            "pooled_scores": pooled_dist_scores.launches,
            "pooled_scores_bwd": pooled_dist_scores.backward_launches}


def resumed_job(folder: str, checkpoint: str, **overrides):
    """A prepared training job on ``checkpoint`` of ``folder``, as ``resume``
    builds it, with configuration overrides."""
    from kge_tpu_torch import Config
    from kge_tpu_torch.job import Job
    from kge_tpu_torch.utils.io import load_checkpoint

    config = Config()
    config.load(os.path.join(folder, "config.yaml"))
    config.folder = folder
    for key, value in overrides.items():
        config.set(key, value)
    job = Job.create_from(load_checkpoint(os.path.join(folder, checkpoint)),
                          new_config=config)
    job._prepare()
    job._is_prepared = True
    return job


def tables_of(job, state=False):
    """Copies of the job's tables, with ``state`` followed by its optimizer
    state's tensors."""
    out = [p.detach().clone() for p in job.optimizer.params]
    if state:
        out += [leaf[k].clone() for leaf in job.opt_state["leaves"]
                for k in sorted(leaf)]
    return out


def one_step_each(folder, checkpoint, key, values, state=False):
    """The same step (same state, batch and negatives) under two values of
    one configuration key; returns (tables before, tables after per value,
    the batch, the jobs). With ``state`` the optimizer state counts as
    tables."""
    jobs = [resumed_job(folder, checkpoint, **{key: value}) for value in values]
    batch = next(iter(jobs[0]._batches()))
    device = jobs[0].device
    batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
             if k != "true_size"}
    batch = jobs[0]._with_negatives(batch)
    before = tables_of(jobs[0], state)
    after = []
    for job in jobs:
        job._train_step(dict(batch), job._current_lrs())
        after.append(tables_of(job, state))
    torch.cuda.synchronize()
    return before, after, batch, jobs


def check_tables_close(a, b, what):
    worst = 0.0
    for x, y in zip(a, b):
        err = (x - y).abs()
        check(bool((err <= 1e-6 + 1e-5 * y.abs()).all()), what)
        worst = max(worst, float(err.max()))
    return worst


def warm_epoch(job, num_train: int, what: str):
    """A warm epoch of a prepared job: wall by the host clock around work
    that ends in a synchronize, then the same under the profiler."""
    job.epoch += 1
    job.run_epoch()  # warms allocator and caches
    torch.cuda.synchronize()
    start = time.perf_counter()
    job.epoch += 1
    entry = job.run_epoch()
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    log(f"  warm epoch of {what}: wall {wall:.3f} s ({num_train / wall:.1f} "
        f"triples/s), {entry['batches']} batches, avg_loss {entry['avg_loss']:.4f}")

    def profiled():
        job.epoch += 1
        job.run_epoch()

    profile = profile_run(profiled, f"warm epoch of {what}")
    return {"wall_s": wall, "triples_per_s": num_train / wall, "profile": profile}


def run_dense_training(seed: int, data: str):
    """Phase 6; returns a summary dict."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.utils.io import load_checkpoint

    num_train, num_valid = FB15K237[2], FB15K237[3]
    steps = -(-num_train // TRAIN_BATCH)
    valid_batches = -(-num_valid // BATCH)
    folder = os.path.join(WORK, "train_dense")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_dense.yaml")
    write_train_config(conf, data, seed)

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    log(f"  start, 2 epochs and one validation: wall {start_wall:.2f} s; launches {counts}")
    # 5 scatter launches a step: the lookups of s, p and o and one target
    # list per corrupted slot (s and o); 2 rank launches a validation batch
    check(counts["scatter_add_sorted"] == 5 * steps * 2,
          f"scatter launches {counts['scatter_add_sorted']} != 5 x {steps} x 2")
    check(counts["rank_counts"] == 2 * valid_batches,
          f"rank launches {counts['rank_counts']} != 2 x {valid_batches}")
    check(counts["rows_set"] == 0, "the dense step wrote rows")
    log(f"  scatter kernel: 5 launches x {steps} steps x 2 epochs = "
        f"{counts['scatter_add_sorted']}; rank kernel: 2 x {valid_batches} "
        f"validation batches = {counts['rank_counts']}")
    epochs = trace_entries(folder, event="epoch_completed")
    check([e["epoch"] for e in epochs] == [1, 2], "expected epochs 1 and 2")
    losses = [e["avg_loss"] for e in epochs]
    check(all(np.isfinite(losses)) and losses[1] < losses[0],
          f"loss did not fall: {losses}")
    (valid,) = trace_entries(folder, event="eval_completed")
    check(0.0 < valid["mean_reciprocal_rank_filtered"] <= 1.0)
    log(f"  avg_loss {losses[0]:.4f} -> {losses[1]:.4f}; epoch times "
        f"{epochs[0]['epoch_time']:.3f} s, {epochs[1]['epoch_time']:.3f} s; "
        f"validation MRR filtered {valid['mean_reciprocal_rank_filtered']:.6f}")

    # resume to epoch 3 (valid.last validates the last epoch)
    saved = load_checkpoint(os.path.join(folder, "checkpoint_00002.pt"))
    check(saved["epoch"] == 2 and int(saved["optimizer_state"]["step"]) == 2 * steps)
    reset_counters()
    cli.main(["resume", folder, "--train.max_epochs", "3"])
    torch.cuda.synchronize()
    resumed_counts = read_counters()
    check(resumed_counts["scatter_add_sorted"] == 5 * steps, resumed_counts)
    check(resumed_counts["rank_counts"] == 2 * valid_batches, resumed_counts)
    epochs = trace_entries(folder, event="epoch_completed")
    check([e["epoch"] for e in epochs] == [1, 2, 3], "resume did not run epoch 3")
    check(epochs[2]["avg_loss"] < epochs[1]["avg_loss"], "loss rose after resume")
    (resumed,) = trace_entries(folder, event="job_resumed", job="train")
    check(resumed["epoch"] == 2, "resume did not start from epoch 2")
    last = load_checkpoint(os.path.join(folder, "checkpoint_00003.pt"))
    check(last["epoch"] == 3 and int(last["optimizer_state"]["step"]) == 3 * steps)
    for before, after in zip(saved["optimizer_state"]["leaves"],
                             last["optimizer_state"]["leaves"]):
        # Adagrad's sum only grows: the resumed job went on from the saved one
        check(bool((after["sum"] >= before["sum"]).all())
              and float(after["sum"].sum()) > float(before["sum"].sum()),
              "the resumed job did not start from the saved Adagrad sum")
    log(f"  resume to epoch 3: launches {resumed_counts}, avg_loss "
        f"{epochs[2]['avg_loss']:.4f}, optimizer step {3 * steps}, Adagrad sum "
        f"grew from the saved one")

    before, (kernel, never), _, jobs = one_step_each(
        folder, "checkpoint_00003.pt", "train.pallas_gather", ("always", "never"))
    worst = check_tables_close(
        kernel, never, "a step with the scatter kernel differs from the same "
        "step with torch's indexing backward")
    moved = max(float((a - b).abs().max()) for a, b in zip(kernel, before))
    check(moved > 1e-4, "the step did not move the tables")
    log(f"  one step, scatter kernel vs train.pallas_gather=never: max abs "
        f"difference {worst:.3e} (tables moved by up to {moved:.3e}); "
        f"tolerance atol 1e-6 + rtol 1e-5")
    timing = warm_epoch(jobs[0], num_train, "T-dense")
    return {"launches": counts, "start_wall_s": start_wall, "avg_loss": losses,
            "epoch_time_s": [e["epoch_time"] for e in epochs],
            "step_max_abs_diff_vs_never": worst, "warm_epoch": timing}


def run_sparse_training(seed: int):
    """Phase 7; returns a summary dict."""
    from kge_tpu_torch import cli

    sizes = (SPARSE_ENTITIES,) + FB15K237[1:]
    num_train = sizes[2]
    steps = -(-num_train // TRAIN_BATCH)
    data = os.path.join(WORK, "sparse_synthetic")
    write_dataset(data, seed + 5, sizes=sizes)
    folder = os.path.join(WORK, "train_sparse")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_sparse.yaml")
    write_train_config(conf, data, seed, **{"train.max_epochs": 1, "valid.every": 0})

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    with open(os.path.join(folder, "kge.log")) as f:
        engaged = "Using row-sparse embedding updates" in f.read()
    check(engaged, "train.sparse_embedding_update=auto did not engage at "
          f"{SPARSE_ENTITIES} entities")
    # 4 row writes a step: parameter and Adagrad sum of both tables; 7
    # scatter launches: five lookups on the mini-tables, two segment sums
    check(counts["rows_set"] == 4 * steps,
          f"row-write launches {counts['rows_set']} != 4 x {steps}")
    check(counts["scatter_add_sorted"] == 7 * steps,
          f"scatter launches {counts['scatter_add_sorted']} != 7 x {steps}")
    (epoch,) = trace_entries(folder, event="epoch_completed")
    check(np.isfinite(epoch["avg_loss"]), "loss is not finite")
    log(f"  start, 1 epoch at {SPARSE_ENTITIES} entities: wall {start_wall:.2f} s, "
        f"epoch {epoch['epoch_time']:.3f} s, avg_loss {epoch['avg_loss']:.4f}; the "
        f"log shows the row-sparse path engaged by auto; rows_set 4 x {steps} = "
        f"{counts['rows_set']} launches, scatter 7 x {steps} = "
        f"{counts['scatter_add_sorted']}")

    before, (sparse, dense), batch, jobs = one_step_each(
        folder, "checkpoint_00001.pt", "train.sparse_embedding_update",
        ("auto", "never"))
    check(jobs[0]._sparse_update and not jobs[1]._sparse_update)
    worst = check_tables_close(
        sparse, dense, "the row-sparse step differs from the dense step")
    touched = torch.zeros(SPARSE_ENTITIES, dtype=torch.bool, device=before[0].device)
    for ids in (batch["triples"][:, 0], batch["triples"][:, 2],
                batch["neg_unique_0"], batch["neg_unique_2"]):
        touched[ids] = True
    check(torch.equal(sparse[0][~touched], before[0][~touched]),
          "the row-sparse step changed rows that the batch did not name")
    check(torch.equal(dense[0][~touched], before[0][~touched]))
    moved = float((sparse[0] - before[0]).abs().max())
    check(moved > 1e-4, "the step did not move the tables")
    log(f"  one step, row-sparse vs dense: max abs difference {worst:.3e} "
        f"(tables moved by up to {moved:.3e}; tolerance atol 1e-6 + rtol 1e-5); "
        f"{int((~touched).sum())} untouched entity rows bit-equal")
    del jobs[1], dense
    torch.cuda.empty_cache()
    timing = warm_epoch(jobs[0], num_train, "T-sparse")
    return {"launches": counts, "start_wall_s": start_wall,
            "avg_loss": epoch["avg_loss"], "epoch_time_s": epoch["epoch_time"],
            "step_max_abs_diff_vs_dense": worst, "warm_epoch": timing}


# -- the fused row update against its plain version ------------------------------


def fused_cases(rng):
    """(name, rows, D, ids): the two tables of a P-rotate step. The entity
    table takes the lookups of s and o (power law) and of both pools
    (uniform); the relation table the lookups of p, where a few rows own
    most of the batch."""
    entity_ids = np.concatenate([
        power_law_ids(rng, SPARSE_ENTITIES, 2 * ROTATE_BATCH, 0.8),
        rng.integers(0, SPARSE_ENTITIES, 2 * NUM_NEGATIVES * POOL_FACTOR),
    ])
    return [
        ("entity table", SPARSE_ENTITIES, ROTATE_DIM, entity_ids),
        ("relation table", FB15K237[1], ROTATE_DIM // 2,
         power_law_ids(rng, FB15K237[1], ROTATE_BATCH, 1.0)),
    ]


# (rule, args, step); the first four run at both shapes, the rest at the
# relation table's only
FUSED_RULES = [
    ("adam", {}, 3),
    ("adamw", {"weight_decay": 0.01}, 3),
    ("adagrad", {"weight_decay": 0.01, "lr_decay": 0.1}, 3),
    ("sgd", {"momentum": 0.9, "nesterov": True, "weight_decay": 0.01}, 3),
    ("sgd", {"momentum": 0.9, "dampening": 0.1}, 0),
    ("sgd", {}, 3),
    ("adam", {"weight_decay": 0.01, "betas": (0.8, 0.99)}, 0),
    ("adamax", {"weight_decay": 0.01}, 3),
    ("rmsprop", {}, 3),
    ("rmsprop", {"centered": True, "momentum": 0.9, "weight_decay": 0.01}, 3),
    ("adadelta", {"weight_decay": 0.01}, 3),
]


def fused_state(opt_type, args, rows, D, generator, device):
    """A random parameter and non-zero random states of the rule, so that
    what the rule does to untouched rows shows: first moments in [-0.1,
    0.1), second moments in [0.01, 0.11) (at least the first one's
    square, as the rules keep them)."""
    from kge_tpu_torch.ops.optim import _RULES

    def rand(scale):
        return scale * torch.rand(rows, D, generator=generator, device=device)

    param = rand(0.2) - 0.1
    states = {
        key: rand(0.2) - 0.1 if key in ("m", "momentum", "avg") else 0.01 + rand(0.1)
        for key in _RULES[opt_type][0](param[:1], args)
    }
    return param, states


def signed_updates(ids, D, generator):
    """Row gradients [n, D] of magnitude in [0.1, 1.1) whose sign depends on
    (id, column) only: the duplicates of a row agree in sign, so that no
    row's sum cancels. A sum that cancels is off by rounding in proportion
    to the summed magnitudes, not to its own value (phase 5 holds the
    scatter kernel to that), and Adam's ``m_hat / (sqrt(v_hat) + eps)`` or
    Adagrad's first step would turn such a gradient's uncertain sign into
    a step of +-lr: the rule's arithmetic is checked where that cannot
    happen."""
    n = ids.shape[0]
    magnitude = 0.1 + torch.rand(n, D, generator=generator, device=ids.device)
    columns = torch.arange(D, device=ids.device)
    sign = ((ids[:, None] + columns[None, :]) % 2) * 2 - 1
    return magnitude * sign


def compare_fused_update(seed: int, device) -> float:
    """Phase 9; returns the largest |error| of Adam at the entity table."""
    from kge_tpu_torch.ops.optim import (
        fused_sorted_update,
        fused_sorted_update_plain,
    )

    rng = np.random.default_rng(seed + 7)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 7)
    main_err = None
    lr = ROTATE_LR
    for case, (name, rows, D, ids_np) in enumerate(fused_cases(rng)):
        ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
        n = len(ids_np)
        touched = torch.zeros(rows, dtype=torch.bool, device=device)
        touched[ids] = True
        duplicates = n - int(touched.sum())
        log(f"  {name} [{rows}, {D}], n={n} row gradients, "
            f"{100 * duplicates / n:.1f}% duplicate ids, "
            f"{int((~touched).sum())} untouched rows")
        for opt_type, args, step in (FUSED_RULES[:4] if case == 0 else FUSED_RULES):
            param, states = fused_state(opt_type, args, rows, D, generator, device)
            upd = signed_updates(ids, D, generator)
            ref_param = param.double()
            ref_states = {k: v.double() for k, v in states.items()}
            fused_sorted_update_plain(opt_type, args, ids, upd.double(), ref_param,
                                      ref_states, lr, step)
            runs = []
            for _ in range(2):
                p = param.clone()
                st = {k: v.clone() for k, v in states.items()}
                ptrs = [p.data_ptr()] + [st[k].data_ptr() for k in sorted(st)]
                before = fused_sorted_update.launches
                out = fused_sorted_update(opt_type, args, ids, upd, p, st, lr, step)
                torch.cuda.synchronize()
                check(fused_sorted_update.launches == before + 1,
                      "fused update launches not counted")
                check(out is st and ptrs == [p.data_ptr()]
                      + [st[k].data_ptr() for k in sorted(st)],
                      "the fused update moved the parameter or a state")
                runs.append((p, st))
            (p, st), (p2, st2) = runs
            check(torch.equal(p, p2) and all(torch.equal(st[k], st2[k]) for k in st),
                  f"fused update not deterministic ({opt_type}, {name})")
            worst, worst_ratio = 0.0, 0.0
            for what, got, ref in [("param", p, ref_param)] + [
                (k, st[k], ref_states[k]) for k in sorted(st)
            ]:
                err = (got.double() - ref).abs()
                ratio = float((err / (1e-6 + 1e-5 * ref.abs())).max())
                check(ratio <= 1.0, f"fused update {opt_type} {args} at the {name}: "
                      f"{what} off by {float(err.max()):.3e} ({ratio:.2f} x tolerance)")
                worst, worst_ratio = max(worst, float(err.max())), max(worst_ratio, ratio)
            moved = float((p - param)[~touched].abs().max()) if (~touched).any() else 0.0
            zero_gradient = opt_type == "adamw" or not args.get("weight_decay")
            if opt_type in ("adam", "adamw") and zero_gradient and (~touched).any():
                b1, b2 = args.get("betas", (0.9, 0.999))
                check(torch.equal(st["m"][~touched], (b1 * states["m"])[~touched])
                      and torch.equal(st["v"][~touched], (b2 * states["v"])[~touched]),
                      "Adam's moments of untouched rows are not beta * moment")
                check(moved > 0, "Adam left untouched rows where they were")
            log(f"    {opt_type} {args} step {step}: max abs err {worst:.3e} "
                f"({worst_ratio:.3f} x tolerance), untouched rows moved by up to "
                f"{moved:.3e}, storage kept, two launches bit-equal")
            if main_err is None:
                main_err = worst
            del param, states, upd, ref_param, ref_states, runs, p, st, p2, st2
        torch.cuda.empty_cache()
    return main_err


# -- the pooled distance kernels against their plain version ----------------------


def pooled_inputs(kind, n, K, F, d, generator, device, stride_parts=False):
    """Random queries, pool and sel; a few rows' queries equal one of their
    candidates (distance 0: sign(0) and the modulus' epsilon). With
    ``stride_parts`` the two pool parts are the column halves of one table,
    as the model passes them."""
    parts = 1 if kind == "l1" else 2

    def randn(*shape):
        return torch.randn(*shape, generator=generator, device=device)

    sel = torch.randint(0, F, (n, K), generator=generator, device=device,
                        dtype=torch.int32)
    if stride_parts and parts == 2:
        pools = list(torch.chunk(randn(K * F, 2 * d), 2, dim=1))
    else:
        pools = [randn(K * F, d) for _ in range(parts)]
    queries = [randn(n, d) for _ in range(parts)]
    for i in range(0, n, max(1, n // 7)):
        j = i % K
        for q, pool in zip(queries, pools):
            q[i] = pool[j * F + int(sel[i, j])]
    return queries, pools, sel


def pooled_reference(queries, pools, sel, F, kind, g, rows_per_chunk=512):
    """Scores, dq and dpool of the plain version in float64, a chunk of
    rows at a time, and the magnitude sums of the tolerance: |factor| <= |g|,
    so dq[i] adds up at most sum_j |g[i, j]| and dpool[j F + f] at most the
    sum of |g[i, j]| over the rows that selected it."""
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores_plain

    n, K = sel.shape
    pools64 = [p.double().requires_grad_(True) for p in pools]
    scores, dqs = [], [[] for _ in queries]
    dpools = [torch.zeros_like(p) for p in pools64]
    for start in range(0, n, rows_per_chunk):
        rows = slice(start, start + rows_per_chunk)
        q64 = [q[rows].double().requires_grad_(True) for q in queries]
        out = pooled_dist_scores_plain(q64, pools64, sel[rows], F, kind)
        grads = torch.autograd.grad(out, q64 + pools64, g[rows].double())
        scores.append(out.detach())
        for part, dq in enumerate(grads[:len(q64)]):
            dqs[part].append(dq)
        for part, dp in enumerate(grads[len(q64):]):
            dpools[part] += dp
    pool_rows = (torch.arange(K, device=sel.device)[None, :] * F + sel.long())
    mag_pool = torch.zeros(K * F, dtype=torch.float64, device=sel.device)
    mag_pool.index_add_(0, pool_rows.reshape(-1), g.double().abs().reshape(-1))
    return (torch.cat(scores), [torch.cat(d) for d in dqs], dpools,
            g.double().abs().sum(dim=1), mag_pool)


POOLED_CASES = [
    # (name, kind, n, K, F, d, pool parts as column halves of one table)
    ("TransE d=128", "l1", TRAIN_BATCH, NUM_NEGATIVES, POOL_FACTOR, TRANSE_DIM, False),
    ("TransE d=512", "l1", TRAIN_BATCH, NUM_NEGATIVES, POOL_FACTOR, 512, False),
    ("RotatE d=1024", "cmod", ROTATE_BATCH, NUM_NEGATIVES, POOL_FACTOR,
     ROTATE_DIM // 2, True),
    ("odd l1", "l1", 37, 5, 3, 100, False),
    ("odd cmod", "cmod", 37, 5, 3, 100, True),
    ("scalar l1", "l1", 37, 5, 3, 51, False),
    ("scalar cmod", "cmod", 37, 5, 3, 51, True),
]


def compare_pooled(seed: int, device):
    """Phase 10; returns (max |scores error|, max |gradient error|) at
    P-rotate's shape."""
    from kge_tpu_torch.ops.dist_pool import pooled_dist_scores

    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 8)
    main = None
    for name, kind, n, K, F, d, stride_parts in POOLED_CASES:
        queries, pools, sel = pooled_inputs(kind, n, K, F, d, generator, device,
                                            stride_parts)
        g = torch.randn(n, K, generator=generator, device=device)
        runs = []
        for _ in range(2):
            leaves = [t.clone().requires_grad_(True) for t in queries + pools]
            if stride_parts and kind == "cmod":
                table = torch.cat(pools, dim=1).requires_grad_(True)
                leaves[2:] = torch.chunk(table, 2, dim=1)
            fwd, bwd = (pooled_dist_scores.launches,
                        pooled_dist_scores.backward_launches)
            out = pooled_dist_scores(leaves[:len(queries)], leaves[len(queries):],
                                     sel, F, kind)
            grads = torch.autograd.grad(out, leaves, g)
            torch.cuda.synchronize()
            check(pooled_dist_scores.launches == fwd + 1
                  and pooled_dist_scores.backward_launches == bwd + 1,
                  "pooled kernel launches not counted")
            runs.append((out.detach(), grads))
        (out, grads), (out2, grads2) = runs
        check(torch.equal(out, out2)
              and all(torch.equal(a, b) for a, b in zip(grads, grads2)),
              f"pooled kernels not deterministic ({name})")
        ref, ref_dqs, ref_dpools, mag_q, mag_pool = pooled_reference(
            queries, pools, sel, F, kind, g)
        err = (out.double() - ref).abs()
        check(bool((err <= 1e-6 + 1e-5 * ref.abs()).all()),
              f"pooled scores disagree with the plain version ({name})")
        grad_err = 0.0
        parts = len(queries)
        for what, got, want, mag in (
            [("dq", a, b, mag_q) for a, b in zip(grads[:parts], ref_dqs)]
            + [("dpool", a, b, mag_pool) for a, b in zip(grads[parts:], ref_dpools)]
        ):
            e = (got.double() - want).abs()
            check(bool((e <= 1e-6 + 1e-5 * mag[:, None]).all()),
                  f"pooled {what} disagrees with the plain version ({name}): "
                  f"max abs err {float(e.max()):.3e}")
            grad_err = max(grad_err, float(e.max()))
        zero_rows = int((ref == 0).sum()) if kind == "l1" else int(
            (ref.abs() <= 1.01e-15 * d).sum())
        log(f"  {name} ({kind}) n={n} K={K} F={F} d={d}: scores max abs err "
            f"{float(err.max()):.3e} (|score| up to {float(ref.abs().max()):.1f}), "
            f"dq/dpool max abs err {grad_err:.3e}; {zero_rows} scores at distance 0; "
            f"two launches bit-equal")
        if name == "RotatE d=1024":
            main = (float(err.max()), grad_err)
        del queries, pools, sel, g, runs, out, grads, out2, grads2, ref, ref_dqs
        del ref_dpools
        torch.cuda.empty_cache()
    return main


# -- training with pooled negatives -------------------------------------------------


def pooled_config(which: str):
    """Overrides of ``write_train_config`` for bench.py's transe_margin and
    rotate_selfadv workloads."""
    common = {"negative_sampling.shared": False, "valid.every": 0}
    if which == "transe":
        return {**common, "model": "transe", "lookup_embedder.dim": TRANSE_DIM,
                "train.loss": "margin_ranking",
                "train.loss_arg": 4.0, "train.max_epochs": 2}
    return {**common, "model": "rotate", "lookup_embedder.dim": ROTATE_DIM,
            "train.loss": "bce_self_adversarial", "train.batch_size": ROTATE_BATCH,
            "train.max_epochs": 1,
            "train.optimizer.default": {"type": "Adam", "args": {"lr": ROTATE_LR}}}


def check_pooled_counts(counts, steps, scatter_per_step, fused_per_step, what):
    """Per step two corrupted entity slots: one pooled forward and one
    backward each."""
    expected = {"pooled_scores": 2 * steps, "pooled_scores_bwd": 2 * steps,
                "scatter_add_sorted": scatter_per_step * steps,
                "fused_row_update": fused_per_step * steps, "rows_set": 0,
                "rank_counts": 0, "rank_counts_epilogue": 0}
    check(counts == expected, f"{what}: launches {counts} != {expected}")


def run_transe_training(seed: int, data: str):
    """Phase 11; returns a summary dict."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.utils.io import load_checkpoint

    num_train = FB15K237[2]
    steps = -(-num_train // TRAIN_BATCH)
    folder = os.path.join(WORK, "train_transe")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_transe.yaml")
    write_train_config(conf, data, seed, **pooled_config("transe"))

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    # 12 scatter launches a step: per corrupted slot the lookups of s, p and
    # o (positive score), of the two kept slots, and of the pool
    check_pooled_counts(counts, 2 * steps, 12, 0, "P-transe start")
    with open(os.path.join(folder, "kge.log")) as f:
        check("Set negative_sampling.implementation=pool" in f.read(),
              "auto did not resolve to pool")
    epochs = trace_entries(folder, event="epoch_completed")
    losses = [e["avg_loss"] for e in epochs]
    check([e["epoch"] for e in epochs] == [1, 2] and all(np.isfinite(losses))
          and losses[1] < losses[0], f"P-transe loss did not fall: {losses}")
    log(f"  start, 2 epochs: wall {start_wall:.2f} s; auto resolved to pool; "
        f"launches {counts} (= 2, 2 and 12 a step x {steps} steps x 2 epochs); "
        f"avg_loss {losses[0]:.4f} -> {losses[1]:.4f}")

    reset_counters()
    cli.main(["resume", folder, "--train.max_epochs", "3"])
    torch.cuda.synchronize()
    check_pooled_counts(read_counters(), steps, 12, 0, "P-transe resume")
    epochs = trace_entries(folder, event="epoch_completed")
    check([e["epoch"] for e in epochs] == [1, 2, 3]
          and epochs[2]["avg_loss"] < epochs[1]["avg_loss"],
          "P-transe: resume did not run a better epoch 3")
    last = load_checkpoint(os.path.join(folder, "checkpoint_00003.pt"))
    check(last["epoch"] == 3 and int(last["optimizer_state"]["step"]) == 3 * steps)
    log(f"  resume to epoch 3: avg_loss {epochs[2]['avg_loss']:.4f}, optimizer "
        f"step {3 * steps}")
    job = resumed_job(folder, "checkpoint_00003.pt")
    routes = time_pooled_routes(job)
    timing = warm_epoch(job, num_train, "P-transe")
    return {"launches": counts, "start_wall_s": start_wall, "avg_loss": losses,
            "routes_d128": routes, "warm_epoch": timing, "folder": folder}


def time_pooled_routes(job):
    """The pooled scoring of one batch's subject corruption (forward and
    backward to the tables) by its two routes: the kernel and the one-hot
    select, at d = 128."""
    batch = next(iter(job._batches()))
    triples = torch.as_tensor(batch["triples"]).to(job.device)
    drawn = job._draw_negatives_on_device(triples, 0)
    params = job.optimizer.params
    job._enter_step()
    out = {}
    for mode in ("auto", "never"):
        job.model.config.set("negative_sampling.pooled_kernel", mode)

        def forward():
            return job.model.score_spo_neg_pooled(
                triples, drawn["neg_pool_0"], drawn["neg_sel_0"], POOL_FACTOR, 0)

        def both():
            return torch.autograd.grad(forward().sum(), params)

        with torch.no_grad():
            fwd_ms = time_ms(forward, reps=10)
        out[mode] = {"forward_ms": fwd_ms, "forward_backward_ms": time_ms(both, reps=10)}
    job.model.config.set("negative_sampling.pooled_kernel", "auto")
    log(f"  pooled scoring of one slot at n={triples.shape[0]} d={TRANSE_DIM} "
        f"(lookups and their scatter included): kernel route forward "
        f"{out['auto']['forward_ms']:.4f} ms, forward+backward "
        f"{out['auto']['forward_backward_ms']:.4f} ms; one-hot select route "
        f"{out['never']['forward_ms']:.4f} ms and "
        f"{out['never']['forward_backward_ms']:.4f} ms")
    return out


def run_rotate_training(seed: int):
    """Phase 12; returns a summary dict. Uses the 200,000-entity graph that
    phase 7 wrote."""
    from kge_tpu_torch import cli
    from kge_tpu_torch.utils.io import load_checkpoint

    num_train = FB15K237[2]
    steps = -(-num_train // ROTATE_BATCH)
    data = os.path.join(WORK, "sparse_synthetic")
    folder = os.path.join(WORK, "train_rotate")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_rotate.yaml")
    write_train_config(conf, data, seed, **pooled_config("rotate"))

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    with open(os.path.join(folder, "kge.log")) as f:
        engaged = ("Using row-sparse embedding updates (fused dense-semantics "
                   "kernel)") in f.read()
    check(engaged, "train.sparse_embedding_update=auto did not engage the fused "
          "row update for RotatE with Adam")
    # 14 scatter launches a step: 12 lookups on the mini-tables and the
    # segment sums of the two fused updates
    check_pooled_counts(counts, steps, 14, 2, "P-rotate start")
    (first,) = trace_entries(folder, event="epoch_completed")
    saved = load_checkpoint(os.path.join(folder, "checkpoint_00001.pt"))
    check(int(saved["optimizer_state"]["step"]) == steps)
    for leaf in saved["optimizer_state"]["leaves"]:
        check(sorted(leaf) == ["m", "v"] and float(np.abs(leaf["m"]).max()) > 0
              and float(leaf["v"].min()) >= 0 and float(leaf["v"].max()) > 0,
              "the checkpoint holds no Adam moments")
    log(f"  start, 1 epoch at {SPARSE_ENTITIES} entities: wall {start_wall:.2f} s, "
        f"epoch {first['epoch_time']:.3f} s, avg_loss {first['avg_loss']:.4f}; the "
        f"log shows the row-sparse step with the fused kernel; launches {counts} "
        f"(= 2 fused, 2 + 2 pooled, 14 scatter a step x {steps} steps)")

    reset_counters()
    cli.main(["resume", folder, "--train.max_epochs", "2"])
    torch.cuda.synchronize()
    check_pooled_counts(read_counters(), steps, 14, 2, "P-rotate resume")
    epochs = trace_entries(folder, event="epoch_completed")
    losses = [e["avg_loss"] for e in epochs]
    check([e["epoch"] for e in epochs] == [1, 2] and all(np.isfinite(losses))
          and losses[1] < losses[0], f"P-rotate loss did not fall: {losses}")
    last = load_checkpoint(os.path.join(folder, "checkpoint_00002.pt"))
    check(last["epoch"] == 2 and int(last["optimizer_state"]["step"]) == 2 * steps)
    # had the resumed job started from zero moments, v could not exceed what
    # one epoch accumulates; it went on from the saved ones
    for before, after in zip(saved["optimizer_state"]["leaves"],
                             last["optimizer_state"]["leaves"]):
        check(float(after["v"].sum()) > float(before["v"].sum()),
              "the resumed job did not go on from the saved Adam moments")
    # (the trainer keeps only the newest checkpoint of epochs off
    # train.checkpoint.every, so the first one is gone by now)
    job = resumed_job(folder, "checkpoint_00002.pt")
    for leaf, before in zip(job.opt_state["leaves"], last["optimizer_state"]["leaves"]):
        check(all(np.array_equal(leaf[k].cpu().numpy(), before[k]) for k in ("m", "v")),
              "Adam's moments did not come back from the checkpoint")
    del job
    log(f"  resume to epoch 2: avg_loss {losses[0]:.4f} -> {losses[1]:.4f}, "
        f"optimizer step {2 * steps}, Adam's m and v came back from the checkpoint")

    before, (sparse, dense), batch, jobs = one_step_each(
        folder, "checkpoint_00002.pt", "train.sparse_embedding_update",
        ("auto", "never"), state=True)
    check(jobs[0]._sparse_update and not jobs[1]._sparse_update)
    worst, loose, total = 0.0, 0, 0
    for a, b in zip(sparse, dense):
        err = (a - b).abs()
        off = err > 1e-6 + 1e-5 * b.abs()
        check(bool((err[off] <= 2.1 * ROTATE_LR).all()),
              "the sparse Adam step differs from the dense step by more than 2.1 lr")
        loose += int(off.sum())
        total += err.numel()
        worst = max(worst, float(err.max()))
    check(loose <= 1e-5 * total, f"{loose} of {total} elements of the sparse Adam "
          "step are off the dense step's by more than 1e-6 + 1e-5 |dense|")
    moved = max(float((a - b).abs().max()) for a, b in zip(sparse, before))
    check(moved > 1e-4, "the step did not move the tables")
    log(f"  one step, row-sparse (fused Adam) vs dense, tables and moments of every "
        f"row: max abs difference {worst:.3e}; {loose} of {total} elements beyond "
        f"1e-6 + 1e-5 |dense| (all within 2.1 lr = {2.1 * ROTATE_LR:.1e}; allowed "
        f"{int(1e-5 * total)}); the step moved the tables by up to {moved:.3e}")
    del jobs[1], dense, sparse, before
    torch.cuda.empty_cache()
    timing = warm_epoch(jobs[0], num_train, "P-rotate")
    return {"launches": counts, "start_wall_s": start_wall, "avg_loss": losses,
            "epoch_time_s": [e["epoch_time"] for e in epochs],
            "step_max_abs_diff_vs_dense": worst, "step_elements_beyond_tolerance": loose,
            "warm_epoch": timing}


# -- T-transe-l2: the L2 epilogue, and evaluation of the distance models --------

L2_BATCH, L2_NEGATIVES = 2048, 64   # examples/fb15k-237-transe-negsamp.yaml


def l2_inputs(seed: int, device, n: int = BATCH, dim: int = TRANSE_DIM):
    """The augmented L2 operands of random queries and candidates at the
    evaluation's shape, with the first 8 rows' true candidates moved close
    to their queries (where the expansion cancels), skewed CSR labels and
    the pivot columns."""
    from kge_tpu_torch.models.translation import _l2_factorization

    rng = np.random.default_rng(seed + 13)
    E = NUM_ENTITIES
    q = rng.normal(0, 0.1, (n, dim)).astype(np.float32)
    c = rng.normal(0, 0.1, (E, dim)).astype(np.float32)
    true_np = rng.integers(0, E, n).astype(np.int32)
    c[true_np[:8]] = q[:8] + rng.normal(0, 1e-3, (8, dim))
    query, target_map, score_map = _l2_factorization(torch.tensor(q, device=device))
    targets = target_map(torch.tensor(c, device=device))
    row_ptr, cols = skewed_labels(rng, n, E, device, true=true_np)
    true = torch.tensor(true_np, device=device)
    return query.contiguous(), targets.contiguous(), score_map, row_ptr, cols, true


def compare_epilogue(seed: int, device):
    """The L2 epilogue kernel against its plain version and against the
    identity kernel mapped by the epilogue; returns the largest label-value
    or pivot error against the plain version."""
    from kge_tpu_torch.ops.rank_kernel import (
        fused_rank_counts,
        fused_rank_counts_plain,
    )

    q, targets, score_map, row_ptr, cols, true = l2_inputs(seed, device)
    E = NUM_ENTITIES
    g, c, vals, pivot = fused_rank_counts(q, targets, None, row_ptr, cols, E, ATOL,
                                          RTOL, score_map=score_map, pivot_cols=true)
    _, _, ivals, ipivot = fused_rank_counts(q, targets, None, row_ptr, cols, E,
                                            ATOL, RTOL, pivot_cols=true)
    torch.cuda.synchronize()
    check(torch.equal(score_map(ipivot).view(torch.int32), pivot.view(torch.int32))
          and torch.equal(score_map(ivals).view(torch.int32), vals.view(torch.int32)),
          "the epilogue kernel's pivots or label values are not the identity "
          "kernel's mapped by the epilogue")
    pg, pc, pvals, _ = fused_rank_counts_plain(q, targets, pivot, row_ptr, cols, E,
                                               ATOL, RTOL, score_map=score_map)
    ppivot = fused_rank_counts_plain(q, targets, None, row_ptr, cols, E, ATOL, RTOL,
                                     score_map=score_map, pivot_cols=true)[3]
    worst = 0.0
    for got, want, what in ((vals, pvals, "label values"), (pivot, ppivot, "pivots")):
        err = (got - want).abs()
        check(bool((err <= 1e-6 + 1e-5 * want.abs()).all()),
              f"epilogue kernel {what} disagree with plain")
        worst = max(worst, float(err.max()))
    differ = (g != pg) | (c != pc)
    near = boundary_rows(q, targets, pivot, E, score_map, TRANSE_DIM)
    check(not bool((differ & ~near).any()),
          "epilogue kernel counts disagree with plain away from a tie boundary")
    check(bool((c >= 1).all()), "a true column does not tie with itself")
    check(int(differ.sum()) <= 0.001 * q.shape[0] + 1, "too many boundary rows differ")
    log(f"  L2 epilogue n={q.shape[0]} |E|={E} D'={q.shape[1]}: counts equal on "
        f"{q.shape[0] - int(differ.sum())}/{q.shape[0]} rows ({int(near.sum())} at a "
        f"tie boundary, {int(differ.sum())} of them differ); label values and pivots "
        f"max abs err {worst:.3e} (rtol 1e-5, atol 1e-6); pivots and label values "
        f"are the identity kernel's mapped by the epilogue, bit for bit; close pairs' "
        f"pivots {float(pivot[:8].max()):.3e} at most")
    return worst


def time_epilogue(seed: int, device):
    """The L2 epilogue kernel per call at n = 256, |E| = 14,541, D' = 132,
    beside its plain version, ``matmul`` + the epilogue + compares, and the
    bound."""
    from kge_tpu_torch.ops.rank_kernel import (
        csr_row_ids,
        fused_rank_counts,
        fused_rank_counts_plain,
    )

    q, targets, score_map, row_ptr, cols, true = l2_inputs(seed + 1, device)
    (n, D), E, nnz = q.shape, targets.shape[0], cols.numel()
    rows = csr_row_ids(row_ptr)
    ms = time_ms(lambda: fused_rank_counts(q, targets, None, row_ptr, cols, E, ATOL,
                                           RTOL, score_map=score_map, pivot_cols=true))
    plain_ms = time_ms(lambda: fused_rank_counts_plain(
        q, targets, None, row_ptr, cols, E, ATOL, RTOL, score_map=score_map,
        pivot_cols=true))

    def library():
        scores = score_map(torch.matmul(q, targets.T))
        pivot = scores.gather(1, true.long()[:, None])
        close = torch.isclose(scores, pivot, rtol=RTOL, atol=ATOL)
        greater = (scores > pivot) & ~close
        return greater.sum(1), close.sum(1), scores[rows, cols.long()]

    library_ms = time_ms(library)
    flops = 2.0 * n * E * D
    bound_ms, bound_by = bound(
        4.0 * (n * D + E * D + (n + 1) + nnz + n + 3 * n + nnz), flops)
    log(f"  rank_counts, L2 epilogue, n={n} |E|={E} D'={D} nnz={nnz}: {ms:.4f} ms "
        f"({100 * flops / (ms * 1e-3) / FP32_FLOPS_PER_S:.1f}% of the fp32 rate), "
        f"plain {plain_ms:.4f} ms, library matmul + epilogue + compares "
        f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
    return {"shape": "L2 epilogue, random, skewed labels", "n": n,
            "num_candidates": E, "D": D, "ms": ms, "plain_ms": plain_ms,
            "library_ms": library_ms, "bound_ms": bound_ms, "bound_by": bound_by}


def run_transe_l2(seed: int, data: str, transe_folder: str):
    """Phase 14; returns a summary dict."""
    from kge_tpu_torch import cli

    num_train, num_valid = FB15K237[2], FB15K237[3]
    steps = -(-num_train // L2_BATCH)
    valid_batches = -(-num_valid // BATCH)
    test_batches = -(-NUM_TEST // BATCH)
    folder = os.path.join(WORK, "train_transe_l2")
    shutil.rmtree(folder, ignore_errors=True)
    conf = os.path.join(WORK, "train_transe_l2.yaml")
    write_train_config(conf, data, seed, **{
        "model": "transe", "transe.l_norm": 2.0,
        "lookup_embedder.dim": TRANSE_DIM,
        "lookup_embedder.initialize": "xavier_uniform_",
        "train.batch_size": L2_BATCH, "train.loss": "margin_ranking",
        "train.loss_arg": 4.0, "train.max_epochs": 2,
        "train.optimizer.default": {"type": "Adagrad", "args": {"lr": 0.05}},
        "negative_sampling.shared": False,
        "negative_sampling.num_samples": {"s": L2_NEGATIVES, "p": 0,
                                          "o": L2_NEGATIVES},
        "valid.every": 1})

    reset_counters()
    start = time.perf_counter()
    cli.main(["start", conf, "--folder", folder])
    torch.cuda.synchronize()
    start_wall = time.perf_counter() - start
    counts = read_counters()
    with open(os.path.join(folder, "kge.log")) as f:
        check("Set negative_sampling.implementation=pool" in f.read(),
              "auto did not resolve to pool")
    valid = trace_entries(folder, event="eval_completed")
    check([e["epoch"] for e in valid] == [1, 2], "expected validations at epochs 1 and 2")
    check(os.path.exists(os.path.join(folder, "checkpoint_00002.pt")),
          "checkpoint_00002.pt is missing")
    epochs = trace_entries(folder, event="epoch_completed")
    losses = [e["avg_loss"] for e in epochs]
    check(all(np.isfinite(losses)) and losses[1] < losses[0],
          f"T-transe-l2 loss did not fall: {losses}")
    check(counts["rank_counts"] == counts["rank_counts_epilogue"] == 2 * 2 * valid_batches,
          f"rank launches {counts} != 2 x {valid_batches} x 2 validations, all with "
          "the L2 epilogue")
    check(counts["pooled_scores"] == counts["rows_set"] == 0 and
          counts["scatter_add_sorted"] > 0, counts)
    log(f"  start, 2 epochs ({steps} steps each) and 2 validations: wall "
        f"{start_wall:.2f} s; auto resolved to pool; launches "
        f"{counts}; avg_loss {losses[0]:.4f} -> {losses[1]:.4f}; epoch times "
        f"{epochs[0]['epoch_time']:.3f} s, {epochs[1]['epoch_time']:.3f} s; "
        f"validation MRR filtered {valid[0]['mean_reciprocal_rank_filtered']:.6f} -> "
        f"{valid[1]['mean_reciprocal_rank_filtered']:.6f}; validation walls "
        f"{valid[0]['epoch_time']:.3f} s, {valid[1]['epoch_time']:.3f} s")

    reset_counters()
    start = time.perf_counter()
    cli.main(["test", folder, "--eval.batch_size", str(BATCH)])
    torch.cuda.synchronize()
    test_wall = time.perf_counter() - start
    test_counts = read_counters()
    check(test_counts["rank_counts"] == test_counts["rank_counts_epilogue"]
          == 2 * test_batches, f"test launches {test_counts} != 2 x {test_batches}")
    entry = last_test_entry(folder)
    metrics = {k: v for k, v in entry.items()
               if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
               and not k.endswith("_with_test")}
    check(metrics and all(np.isfinite(v) for v in metrics.values()), metrics)
    check(0.0 < entry["mean_reciprocal_rank_filtered"] <= 1.0)
    log(f"  test: {test_counts['rank_counts']} rank launches, all with the L2 "
        f"epilogue; wall {test_wall:.3f} s ({NUM_TEST / test_wall:.1f} filtered "
        f"triples/s); MRR filtered {entry['mean_reciprocal_rank_filtered']:.6f}, "
        f"Hits@10 filtered {entry['hits_at_10_filtered']:.6f}")

    job = test_job(folder)
    with torch.inference_mode():
        job._prepare()
        job._is_prepared = True
        job._evaluate()
        torch.cuda.synchronize()
        start = time.perf_counter()
        job._evaluate()
        torch.cuda.synchronize()
        warm_test_wall = time.perf_counter() - start
        log(f"  second test eval (collated batches reused): wall {warm_test_wall:.3f} s")
        agree = eval_ranks_agree(job, dim=TRANSE_DIM)
        eval_profile = profile_run(job._evaluate, "warm test eval of T-transe-l2")
    del job
    train_job = resumed_job(folder, "checkpoint_00002.pt")
    timing = warm_epoch(train_job, num_train, "T-transe-l2")
    del train_job

    # TransE-L1 by the score-matrix route: phase 11's folder
    reset_counters()
    start = time.perf_counter()
    cli.main(["test", transe_folder, "--eval.batch_size", str(BATCH)])
    torch.cuda.synchronize()
    l1_wall = time.perf_counter() - start
    l1_counts = read_counters()
    check(l1_counts["rank_counts"] == 0, f"TransE-L1 launched the rank kernel: {l1_counts}")
    l1 = last_test_entry(transe_folder)
    l1_metrics = {k: v for k, v in l1.items()
                  if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
                  and not k.endswith("_with_test")}
    check(l1_metrics and all(np.isfinite(v) for v in l1_metrics.values()), l1_metrics)
    check(0.0 < l1["mean_reciprocal_rank_filtered"] <= 1.0)
    log(f"  test of P-transe's folder (TransE-L1, score matrix): wall {l1_wall:.3f} s "
        f"({NUM_TEST / l1_wall:.1f} filtered triples/s), MRR filtered "
        f"{l1['mean_reciprocal_rank_filtered']:.6f}, no rank kernel launch")
    job = test_job(transe_folder)
    with torch.inference_mode():
        job._prepare()
        job._is_prepared = True
        job._evaluate()
        l1_profile = profile_run(job._evaluate, "warm test eval of TransE-L1")
    del job
    return {"launches": counts, "test_launches": test_counts,
            "start_wall_s": start_wall, "avg_loss": losses,
            "epoch_time_s": [e["epoch_time"] for e in epochs],
            "valid_wall_s": [e["epoch_time"] for e in valid],
            "valid_mrr_filtered": [e["mean_reciprocal_rank_filtered"] for e in valid],
            "test_wall_s": test_wall, "test_warm_wall_s": warm_test_wall,
            "test_mrr_filtered": entry["mean_reciprocal_rank_filtered"],
            "ranks_vs_plain": agree, "eval_profile": eval_profile,
            "warm_epoch": timing, "transe_l1_test_wall_s": l1_wall,
            "transe_l1_test_mrr_filtered": l1["mean_reciprocal_rank_filtered"],
            "transe_l1_eval_profile": l1_profile}


# -- kernel timings ---------------------------------------------------------------


def rotating(make, copies: int = 4):
    """A callable that runs ``fn`` on ``copies`` input sets in turn, so that
    consecutive calls do not find their inputs in the 50 MB L2 cache."""
    sets = [make() for _ in range(copies)]
    state = {"i": 0}

    def pick():
        state["i"] = (state["i"] + 1) % copies
        return sets[state["i"]]

    return pick


def time_rank(seed: int, device, first_batch):
    """Rank kernel per call: at the evaluation's first batch (q, targets,
    row_ptr, cols, true: the kernels line's shape), and on random inputs
    with one label a row at n = 1,024 and over 200,000 candidates. Beside
    the planned grid (one tile a block) the same call with one wave of
    blocks, which is what the plan was chosen against."""
    from kge_tpu_torch.ops.rank_kernel import (
        csr_row_ids,
        fused_rank_counts,
        fused_rank_counts_plain,
        rank_plan,
    )

    generator = torch.Generator(device=device).manual_seed(seed + 11)
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    cases = [("first test batch", first_batch)]
    for n, E in ((1024, NUM_ENTITIES), (BATCH, SPARSE_ENTITIES)):
        true = torch.randint(0, E, (n,), generator=generator, device=device,
                             dtype=torch.int32)
        cases.append(("random, one label a row", (
            torch.randn(n, DIM, generator=generator, device=device) * 0.05,
            torch.randn(E, DIM, generator=generator, device=device) * 0.05,
            torch.arange(n + 1, dtype=torch.int32, device=device), true, true)))
    out = []
    for name, (q, targets, row_ptr, cols, true) in cases:
        (n, D), E, nnz = q.shape, targets.shape[0], cols.numel()
        planned = rank_plan(n, E)
        one_wave = rank_plan(n, E, num_ranges=2 * sms // planned["row_tiles"])

        def kernel(plan=None):
            return fused_rank_counts(q, targets, None, row_ptr, cols, E, ATOL, RTOL,
                                     pivot_cols=true, plan=plan)

        before = fused_rank_counts.launches
        ms = time_ms(kernel)
        check(fused_rank_counts.launches > before)
        one_wave_ms = time_ms(lambda: kernel(one_wave))
        plain_ms = time_ms(lambda: fused_rank_counts_plain(
            q, targets, None, row_ptr, cols, E, ATOL, RTOL, pivot_cols=true))
        rows = csr_row_ids(row_ptr)

        def library():
            scores = torch.matmul(q, targets.T)
            pivot = scores.gather(1, true.long()[:, None])
            close = torch.isclose(scores, pivot, rtol=RTOL, atol=ATOL)
            greater = (scores > pivot) & ~close
            return greater.sum(1), close.sum(1), scores[rows, cols.long()]

        library_ms = time_ms(library)
        flops = 2.0 * n * E * D + 2.0 * n * D
        bound_ms, bound_by = bound(
            4.0 * (n * D + E * D + (n + 1) + nnz + n + 3 * n + nnz), flops)
        rate = flops / (ms * 1e-3) / FP32_FLOPS_PER_S
        log(f"  rank_counts {name} n={n} |E|={E} D={D} nnz={nnz}: {ms:.4f} ms "
            f"({planned['row_tiles']} x {planned['num_ranges']} blocks of one tile, "
            f"{100 * rate:.1f}% of the fp32 rate; as one wave of "
            f"{one_wave['row_tiles']} x {one_wave['num_ranges']} blocks of "
            f"{one_wave['tiles_per_range']} tiles {one_wave_ms:.4f} ms), plain "
            f"{plain_ms:.4f} ms, library matmul + compares {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by})")
        out.append({"shape": name, "n": n, "num_candidates": E, "ms": ms,
                    "one_wave_ms": one_wave_ms, "share_of_fp32_rate": rate,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by})
    return out


def time_scatter(seed: int, device):
    """Scatter kernel per call at the three shapes of the dense step (the
    first is the kernels line's), at P-transe's d = 128 and at T-sparse's
    entity segment sum: the wrapper and its two launches alone, and the
    segment sums with their launch A, the sort without zeros to write."""
    from kge_tpu_torch.ops.embedding_ops import (
        scatter_launch,
        sorted_scatter_add,
        sorted_scatter_add_plain,
        sorted_segment_sums,
    )

    rng = np.random.default_rng(seed + 4)
    cases = [case + (DIM,) for case in scatter_cases(rng)[:3]] + [
        ("entity lookups, d = 128",
         power_law_ids(rng, NUM_ENTITIES, TRAIN_BATCH, 0.8), NUM_ENTITIES, TRANSE_DIM),
        ("row-sparse entity ids", rows_set_cases(rng)[0][2], SPARSE_ENTITIES, DIM),
    ]
    out = []
    for name, ids_np, num_rows, D in cases:
        n = len(ids_np)

        def make():
            return (torch.tensor(ids_np, dtype=torch.int64, device=device),
                    torch.randn(n, D, device=device))

        pick = rotating(make)
        ms = time_ms(lambda: sorted_scatter_add(*pick(), num_rows))
        plain_ms = time_ms(lambda: sorted_scatter_add_plain(*pick(), num_rows))
        ids, upd = pick()
        buffers = scatter_launch(ids, None, upd, num_rows)
        sort_ms = time_ms(lambda: scatter_launch(
            pick()[0], None, upd, num_rows, phases=1, buffers=buffers))
        sums_ms = time_ms(lambda: scatter_launch(
            ids, None, pick()[1], num_rows, phases=2, buffers=buffers))
        segments_ms = time_ms(lambda: sorted_segment_sums(*pick(), num_rows))
        by_segment = scatter_launch(ids, None, upd, num_rows, by_segment=True)
        sort_alone_ms = time_ms(lambda: scatter_launch(
            pick()[0], None, upd, num_rows, by_segment=True, phases=1,
            buffers=by_segment))

        def library():
            ids, upd = pick()
            return torch.zeros(num_rows, D, device=device).index_add_(0, ids, upd)

        library_ms = time_ms(library)
        # the unsorted int64 ids and the updates read once, the table written
        # once: the same work whatever sorts
        bound_ms, bound_by = bound(4.0 * (n * D + num_rows * D) + 8.0 * n,
                                   float(n * D))
        log(f"  scatter_add_sorted {name} n={n} rows={num_rows} D={D}: {ms:.4f} ms "
            f"(launch A alone, the sort beside the zeros, {sort_ms:.4f} ms; launch "
            f"B alone, the sums, {sums_ms:.4f} ms), plain {plain_ms:.4f} ms, "
            f"library index_add_ {library_ms:.4f} ms, bound {bound_ms:.4f} ms "
            f"({bound_by}); segment sums {segments_ms:.4f} ms (their launch A, the "
            f"sort without zeros, {sort_alone_ms:.4f} ms)")
        out.append({"shape": name, "n": n, "num_rows": num_rows, "dim": D, "ms": ms,
                    "sort_and_zero_ms": sort_ms, "sums_ms": sums_ms,
                    "segment_sums_ms": segments_ms, "sort_alone_ms": sort_alone_ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": bound_by})
    return out


def time_rows_set(seed: int, device):
    """Row-write kernel per call at the two shapes of the row-sparse step."""
    from kge_tpu_torch.ops.embedding_ops import rows_set, rows_set_plain

    rng = np.random.default_rng(seed + 6)
    out = []
    for name, num_rows, ids_np in rows_set_cases(rng):
        m = len(ids_np)
        table = torch.zeros(num_rows, DIM, device=device)
        values = torch.randn(num_rows, DIM, device=device)

        def make():
            ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
            return ids, values[ids]

        pick = rotating(make)
        ms = time_ms(lambda: rows_set(table, *pick()))
        plain_ms = time_ms(lambda: rows_set_plain(table, *pick()))
        library_ms = time_ms(lambda: table.index_copy_(0, *pick()))
        nbytes = 4.0 * 2 * m * DIM + 8.0 * m
        bound_ms = nbytes / HBM_BYTES_PER_S * 1e3
        log(f"  rows_set {name} m={m} into [{num_rows}, {DIM}]: {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms, library index_copy_ {library_ms:.4f} ms, bound "
            f"{bound_ms:.4f} ms (bytes)")
        out.append({"shape": name, "m": m, "num_rows": num_rows, "ms": ms,
                    "plain_ms": plain_ms, "library_ms": library_ms,
                    "bound_ms": bound_ms, "bound_by": "bytes"})
    return out


def bound(nbytes: float, flops: float):
    """(bound_ms, bound_by): the larger of bytes over the card's memory rate
    and operations over its fp32 rate."""
    by_bytes, by_flops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(by_bytes, by_flops) * 1e3, "bytes" if by_bytes >= by_flops else "operations"


def time_fused_update(seed: int, device):
    """Fused row update (Adam) per call at the two tables of a P-rotate
    step; the first is the kernels line's."""
    from kge_tpu_torch.ops.optim import (
        fused_sorted_update,
        fused_sorted_update_plain,
        fused_update_presummed,
        segment_sums,
    )

    rng = np.random.default_rng(seed + 9)
    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 9)
    out = []
    lr, step = ROTATE_LR, 3
    for name, rows, D, ids_np in fused_cases(rng):
        n = len(ids_np)
        ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
        upd = signed_updates(ids, D, generator)
        param, states = fused_state("adam", {}, rows, D, generator, device)
        ms = time_ms(lambda: fused_sorted_update(
            "adam", {}, ids, upd, param, states, lr, step), reps=10)
        segments_ms = time_ms(lambda: segment_sums(ids, upd, rows), reps=10)
        segments = segment_sums(ids, upd, rows)
        kernel_only_ms = time_ms(lambda: fused_update_presummed(
            "adam", {}, *segments, param, states, lr, step), reps=10)
        plain_ms = time_ms(lambda: fused_sorted_update_plain(
            "adam", {}, ids, upd, param, states, lr, step), reps=5)

        # library route: a dense gradient by index_add_, then torch's fused Adam
        weight = torch.nn.Parameter(param.clone())
        adam = torch.optim.Adam([weight], lr=lr, fused=True)

        def library():
            weight.grad = torch.zeros_like(weight).index_add_(0, ids, upd)
            adam.step()

        library_ms = time_ms(library, reps=10)
        del weight, adam
        # param and both moments read and written once, the row gradients
        # and their ids read once; a dozen operations per element
        nbytes = 4.0 * (2 * 3 * rows * D + n * D) + 8.0 * n
        bound_ms, bound_by = bound(nbytes, 12.0 * rows * D)
        log(f"  fused_row_update (Adam) {name} [{rows}, {D}] n={n}: {ms:.4f} ms (the "
            f"wrapper: segment_sums, which is the scatter kernel's sort and sums, "
            f"{segments_ms:.4f} ms, and the kernel, alone {kernel_only_ms:.4f} ms), "
            f"plain {plain_ms:.4f} "
            f"ms, library index_add_ + torch.optim.Adam(fused=True) {library_ms:.4f} "
            f"ms, bound {bound_ms:.4f} ms ({bound_by})")
        out.append({"shape": name, "rows": rows, "D": D, "n": n, "ms": ms,
                    "segment_sums_ms": segments_ms,
                    "kernel_only_ms": kernel_only_ms, "plain_ms": plain_ms,
                    "library_ms": library_ms, "bound_ms": bound_ms,
                    "bound_by": bound_by})
        del param, states, upd, segments
        torch.cuda.empty_cache()
    return out


def time_pooled(seed: int, device):
    """Pooled distance kernels per call, forward and backward, at P-rotate's
    shape (first: the kernels line's) and P-transe's two."""
    from kge_tpu_torch.ops.dist_pool import (
        pooled_dist_scores,
        pooled_dist_scores_plain,
    )

    generator = torch.Generator(device=device)
    generator.manual_seed(seed + 10)
    forward, backward = [], []
    order = [POOLED_CASES[2], POOLED_CASES[0], POOLED_CASES[1]]
    for name, kind, n, K, F, d, _ in order:
        queries, pools, sel = pooled_inputs(kind, n, K, F, d, generator, device)
        g = torch.randn(n, K, generator=generator, device=device)
        leaves = [t.requires_grad_(True) for t in queries + pools]
        parts = len(queries)
        rows = torch.arange(K, device=device)[None, :] * F + sel.long()

        def run(fn):
            return fn(leaves[:parts], leaves[parts:], sel, F, kind)

        def library():
            # one library call that covers the function: all n x K F L1
            # distances, of which each row keeps its K
            return -torch.cdist(leaves[0], leaves[parts], p=1).gather(1, rows)

        elements = float(n) * K * d
        ops = 4.0 if kind == "l1" else 8.0
        read = 4.0 * (parts * (n * d + K * F * d) + n * K)
        times = {}
        for what, fn in (("kernel", lambda: run(pooled_dist_scores)),
                         ("plain", lambda: run(pooled_dist_scores_plain)),
                         ("library", library if kind == "l1" else None)):
            if fn is None:
                times[what] = (None, None)
                continue
            with torch.no_grad():
                fwd_ms = time_ms(fn, reps=10)
            out = fn()
            bwd_ms = time_ms(
                lambda: torch.autograd.grad(out, leaves, g, retain_graph=True), reps=10)
            times[what] = (fwd_ms, bwd_ms)
            del out
        fwd_bound = bound(read + 4.0 * n * K, ops * elements)
        bwd_bound = bound(read + 4.0 * n * K + 4.0 * parts * (n * d + K * F * d),
                          2 * ops * elements)
        library_name = "cdist(p=1) + gather" if kind == "l1" else "none for cmod"
        for label, index, (bound_ms, bound_by), sink in (
            ("pooled_scores", 0, fwd_bound, forward),
            ("pooled_scores_bwd", 1, bwd_bound, backward),
        ):
            lib_ms = times["library"][index]
            log(f"  {label} {name} ({kind}) n={n} K={K} F={F} d={d}: "
                f"{times['kernel'][index]:.4f} ms, plain {times['plain'][index]:.4f} "
                f"ms, library ({library_name}) "
                f"{'null' if lib_ms is None else format(lib_ms, '.4f') + ' ms'}, "
                f"bound {bound_ms:.4f} ms ({bound_by})")
            sink.append({"shape": name, "kind": kind, "n": n, "K": K, "F": F, "d": d,
                         "ms": times["kernel"][index],
                         "plain_ms": times["plain"][index], "library_ms": lib_ms,
                         "bound_ms": bound_ms, "bound_by": bound_by})
        del queries, pools, sel, g, leaves, rows
        torch.cuda.empty_cache()
    return forward, backward


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA card available")

    from kge_tpu_torch import cli
    from kge_tpu_torch.ops import kernel_utils
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    device = torch.device("cuda")
    card = card_line()

    log("== phase 1: card and build")
    log(f"  {card}; torch {torch.__version__}, CUDA {torch.version.cuda}")
    start = time.perf_counter()
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(kernel_utils.build, KERNELS))
    log(f"  built {len(KERNELS)} kernels side by side in "
        f"{time.perf_counter() - start:.2f} s")
    for name in KERNELS:
        kernel_utils.load_library(name)
        log(f"  csrc/{name}.cu: nvcc {kernel_utils.build_seconds[name]:.2f} s")
        for line in kernel_utils.build_log.get(name, "").splitlines():
            if "registers" in line or "spill" in line:
                log("   " + line.strip())

    log("== phase 2: rank kernel vs plain version")
    max_err, excluded, rows = compare_kernel(args.seed, device)
    log(f"  {excluded} of {rows} rows excluded at tie boundaries")

    log("== phase 3: main path (reciprocal ComplEx d=512, FB15k-237 sizes)")
    data = os.path.join(WORK, "fb15k237_synthetic")
    write_dataset(data, args.seed)
    folder = os.path.join(WORK, "experiment")
    write_checkpoint(folder, data, args.seed, "auto", DIM, BATCH)
    fused_rank_counts.launches = 0
    torch.cuda.synchronize()
    start = time.perf_counter()
    cli.main(["test", folder, "--eval.batch_size", str(BATCH)])
    torch.cuda.synchronize()
    wall = time.perf_counter() - start
    launches = fused_rank_counts.launches
    entry = last_test_entry(folder)
    num_batches = -(-NUM_TEST // BATCH)
    check(launches == 2 * num_batches, (launches, num_batches))
    # the validation metric (filtered_with_test) is not computed on test
    metrics = {k: v for k, v in entry.items()
               if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
               and not k.endswith("_with_test")}
    check(metrics and all(np.isfinite(v) for v in metrics.values()), metrics)
    check(0.0 < entry["mean_reciprocal_rank_filtered"] <= 1.0)
    log(f"  test eval: {launches} kernel launches, wall {wall:.3f} s "
        f"({NUM_TEST / wall:.1f} filtered triples/s), "
        f"MRR filtered {entry['mean_reciprocal_rank_filtered']:.6f}, "
        f"Hits@10 filtered {entry['hits_at_10_filtered']:.6f}")

    # the same batches through the plain version
    job = test_job(folder)
    with torch.inference_mode():
        job._prepare()
        job._is_prepared = True
        start = time.perf_counter()
        job._evaluate()
        torch.cuda.synchronize()
        warm_wall = time.perf_counter() - start
        _, device_batches = job._collate_cache
        eval_ranks_agree(job)
        log(f"  second test eval (collated batches reused): wall {warm_wall:.3f} s "
            f"({NUM_TEST / warm_wall:.1f} filtered triples/s)")
        small_eval_agrees(args.seed)

        log("== phase 4: where the time goes, and kernel timings")
        profile = profile_run(job._evaluate, "warm eval")

        triples, labels = device_batches[0]
        _, q, targets, _ = job.model.factorized_queries(triples, (2,))[2]
        row_ptr, cols, _, _ = labels["o"]
        true = triples[:, 2].to(torch.int32).contiguous()
        rank_times = time_rank(args.seed, device, (
            q.contiguous(), targets.contiguous(), row_ptr, cols, true))
        log(f"  {card}")

    log("== phase 5: scatter and row-write kernels vs plain versions")
    scatter_err = compare_scatter(args.seed, device)
    rows_set_err = compare_rows_set(args.seed, device)

    log("== phase 6: T-dense (ComplEx d=512, shared negatives, FB15k-237 sizes)")
    dense = run_dense_training(args.seed, data)

    log(f"== phase 7: T-sparse (the same over {SPARSE_ENTITIES} entities)")
    sparse = run_sparse_training(args.seed)

    log("== phase 8: kernel timings at the training shapes")
    scatter_times = time_scatter(args.seed, device)
    rows_set_times = time_rows_set(args.seed, device)
    log(f"  {card}")

    log("== phase 9: fused row-update kernel vs plain version")
    fused_err = compare_fused_update(args.seed, device)

    log("== phase 10: pooled distance kernels vs plain version")
    pooled_err, pooled_grad_err = compare_pooled(args.seed, device)

    log("== phase 11: P-transe (TransE-L1 d=128, pooled negatives, FB15k-237 sizes)")
    transe = run_transe_training(args.seed, data)

    log(f"== phase 12: P-rotate (RotatE-L1 d={ROTATE_DIM}, Adam, {SPARSE_ENTITIES} "
        f"entities)")
    rotate = run_rotate_training(args.seed)

    log("== phase 13: kernel timings at P-rotate's shapes")
    fused_times = time_fused_update(args.seed, device)
    pooled_fwd_times, pooled_bwd_times = time_pooled(args.seed, device)
    log(f"  {card}")

    log("== phase 14: T-transe-l2 (TransE-L2 d=128, FB15k-237 sizes; validation "
        "and test through the L2 epilogue) and the test of a TransE-L1 folder")
    epilogue_err = compare_epilogue(args.seed, device)
    transe_l2 = run_transe_l2(args.seed, data, transe["folder"])
    epilogue_times = time_epilogue(args.seed, device)
    log(f"  {card}")

    def entry(name, replaces, count, max_abs_err, times, source=None, **more):
        main_shape = times[0]
        return dict(
            name=name, route="cuda",
            source=f"kge_tpu_torch/csrc/{source or name}.cu",
            replaces=replaces, launches=count, max_abs_err=max_abs_err,
            ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"], **more)

    kernels = {"kernels": [
        entry("rank_counts", "kge_tpu/ops/rank_kernel.py:108", launches, max_err,
              rank_times, shapes=rank_times,
              epilogue={**epilogue_times, "name": "neg_sqrt_l2",
                        "max_abs_err": epilogue_err},
              launches_transe_l2=transe_l2["launches"]["rank_counts_epilogue"]
              + transe_l2["test_launches"]["rank_counts_epilogue"]),
        entry("scatter_add_sorted", "kge_tpu/ops/pallas_ops.py:120",
              dense["launches"]["scatter_add_sorted"], scatter_err, scatter_times,
              shapes=scatter_times,
              sort_and_zero_ms=scatter_times[0]["sort_and_zero_ms"],
              sums_ms=scatter_times[0]["sums_ms"],
              launches_sparse_epoch=sparse["launches"]["scatter_add_sorted"]),
        entry("rows_set", "kge_tpu/ops/pallas_ops.py:258",
              sparse["launches"]["rows_set"], rows_set_err, rows_set_times,
              shapes=rows_set_times),
        entry("fused_row_update", "kge_tpu/ops/pallas_ops.py:402",
              rotate["launches"]["fused_row_update"], fused_err, fused_times,
              shapes=fused_times),
        entry("pooled_scores", "kge_tpu/ops/dist_pool.py:279",
              rotate["launches"]["pooled_scores"], pooled_err, pooled_fwd_times,
              source="dist_pool", shapes=pooled_fwd_times,
              launches_transe_start=transe["launches"]["pooled_scores"]),
        entry("pooled_scores_bwd", "kge_tpu/ops/dist_pool.py:248",
              rotate["launches"]["pooled_scores_bwd"], pooled_grad_err,
              pooled_bwd_times, source="dist_pool", shapes=pooled_bwd_times,
              launches_transe_start=transe["launches"]["pooled_scores_bwd"]),
    ], "eval_wall_s": wall, "eval_warm_wall_s": warm_wall, "profile": profile,
        "filtered_triples_per_s": NUM_TEST / wall,
        "filtered_triples_per_s_warm": NUM_TEST / warm_wall,
        "train_dense": dense, "train_sparse": sparse,
        "train_transe": transe, "train_rotate": rotate,
        "train_transe_l2": transe_l2, "card": card}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
