"""Smoke run of kge_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every CUDA kernel of the package from ``csrc/`` (one
   ``nvcc`` per source, all started together).
2. The rank kernel (ops/rank_kernel.py) against its plain PyTorch version on
   the card at n = 256 and n = 1024, |E| = 14,541, D = 512, with skewed CSR
   labels and NaN / -inf edge rows. Label values agree within rtol 1e-5
   (atol 1e-6); counts agree on every row except rows where a candidate's
   plain score lies within 4 ulp of a tie boundary pivot +- (atol + rtol
   |pivot|), since cuBLAS sums in another order than the kernel. The rows
   that differ there are excluded, counted, and may be at most 0.1% of the
   rows; the rows at a boundary are counted too.
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
   its bound.
5. The scatter kernel (ops/embedding_ops.py ``sorted_scatter_add``) against
   its plain version in float64 at the shapes of a training step (8,192
   updates into 14,541 entity rows and into 237 relation rows, 129 updates
   into 14,541 rows, all at D = 512), at a mini-table shape (``arange`` ids)
   and with every id equal. A sum of float32 in another order than the
   reference's differs by rounding that grows with the summed magnitudes,
   so the check is ``|kernel - reference| <= 1e-6 + 1e-5 S`` with S the
   row's sum of ``|update|`` (for a row of one update that is rtol 1e-5,
   atol 1e-6); two launches must give the same bits. The row-write kernel
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
   library (``index_add_``, ``index_copy_``) and bound; a warm epoch of
   each training configuration (wall, triples/s) and a profile of it with
   the device's busy share.
9. One ``kernels`` JSON line: per kernel its time per call at the main
   path's shape, launches on its main path, the plain version's and one
   library call's time, and the bound (bytes over 3.35 TB/s or fp32
   operations over 67 TFLOP/s, whichever is larger). Then the card's name
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
KERNELS = ("rank_counts", "scatter_add_sorted", "rows_set")
# training: bench.py's headline workload
TRAIN_BATCH, NUM_NEGATIVES, SPARSE_ENTITIES = 8192, 128, 200000
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


def boundary_rows(q, targets, pivot, num_valid) -> torch.Tensor:
    """Rows where a plain score lies within 4 ulp of pivot +- tolerance:
    there the kernel's summation order may legitimately flip a decision."""
    scores = q @ targets[:num_valid].T
    p = torch.where(torch.isnan(pivot), torch.full_like(pivot, -float("inf")), pivot)
    tol = ATOL + RTOL * p.abs()
    near = torch.zeros(q.shape[0], dtype=torch.bool, device=q.device)
    for bound in (p - tol, p + tol):
        b = bound[:, None]
        ulp = (torch.nextafter(b.abs(), torch.full_like(b, float("inf")))
               - b.abs())
        near |= (((scores - b).abs() <= 4 * ulp) & torch.isfinite(b)).any(dim=1)
    return near


def skewed_labels(rng, n, num_entities, device):
    """CSR labels with FB15k-237-like skew: most rows hold a few labels,
    every 37th row thousands."""
    per_row = []
    for i in range(n):
        k = 3000 if i % 37 == 1 else int(rng.zipf(1.6)) % 200
        per_row.append(np.sort(rng.choice(num_entities, size=k, replace=False)))
    row_ptr = np.concatenate([[0], np.cumsum([len(c) for c in per_row])])
    return (torch.tensor(row_ptr, dtype=torch.int32, device=device),
            torch.tensor(np.concatenate(per_row), dtype=torch.int32, device=device))


def compare_kernel(seed: int, device):
    """Phase 2; returns (max |vals error|, rows excluded, rows)."""
    from kge_tpu_torch.ops.rank_kernel import (
        fused_rank_counts,
        fused_rank_counts_plain,
    )

    rng = np.random.default_rng(seed)
    E, D = NUM_ENTITIES, DIM
    targets = torch.tensor(rng.normal(0, 0.05, (E, D)).astype(np.float32), device=device)
    max_err, excluded, rows = 0.0, 0, 0
    t0 = targets[:, 0].cpu().numpy()
    for n in (256, 1024):
        true_np = rng.integers(0, E, n).astype(np.int32)
        qn = rng.normal(0, 0.05, (n, D)).astype(np.float32)
        qn[2] = np.nan                          # NaN pivot, reads as -inf
        for row, sign in ((5, -1.0), (6, 1.0)):  # -inf and +inf pivots
            qn[row] = 0.0
            qn[row, 0] = sign * np.inf * np.sign(t0[true_np[row]])
        q = torch.tensor(qn, device=device)
        row_ptr, cols = skewed_labels(rng, n, E, device)
        true = torch.tensor(true_np, device=device)
        g, c, vals, pivot = fused_rank_counts(
            q, targets, None, row_ptr, cols, E, ATOL, RTOL, pivot_cols=true,
        )
        torch.cuda.synchronize()
        check(bool(torch.isnan(pivot[2])) and float(pivot[5]) == -float("inf")
              and float(pivot[6]) == float("inf"),
              "edge rows did not give NaN, -inf and +inf pivots")
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
        check(ok_vals, f"rank kernel vals disagree with plain (n={n})")
        max_err = max(max_err, float(err[finite_ref].max()) if finite_ref.any() else 0.0)
        differ = (g != pg) | (c != pc)
        near = boundary_rows(q, targets, pivot, E)
        bad = differ & ~near
        check(not bool(bad.any()), (
            f"rank kernel counts disagree with plain on {int(bad.sum())} "
            f"rows away from a tie boundary (n={n})"
        ))
        excluded += int((differ & near).sum())
        rows += n
        log(f"  n={n}: counts equal on {n - int(differ.sum())}/{n} rows; "
            f"{int(near.sum())} rows lie at a tie boundary, "
            f"{int((differ & near).sum())} of them differ and are excluded; "
            f"vals max abs err {float(err[finite_ref].max()):.3e}")
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
        load_checkpoint(os.path.join(folder, "checkpoint_best.pt")),
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
    top = sorted(events, key=device_us, reverse=True)[:6]
    out = {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if events else None,
        "device_busy_share": busy_ms / wall_ms if events else None,
        "top": [{"name": e.key[:60], "ms": device_us(e) / 1e3, "calls": e.count}
                for e in top],
    }
    if not events:
        log("  profiler recorded no device time: not measured")
    else:
        log(f"  profiled {what}: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
            f"({100 * busy_ms / wall_ms:.1f}%)")
        for t in out["top"]:
            log(f"    {t['ms']:9.3f} ms  {t['calls']:5d} calls  {t['name']}")
    return out


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


def compare_scatter(seed: int, device) -> float:
    """Phase 5, scatter kernel; returns the largest |error| at the three
    shapes of the dense step."""
    from kge_tpu_torch.ops.embedding_ops import (
        sorted_scatter_add,
        sorted_scatter_add_plain,
    )

    rng = np.random.default_rng(seed + 2)
    worst = 0.0
    for index, (name, ids_np, num_rows) in enumerate(scatter_cases(rng)):
        ids = torch.tensor(ids_np, dtype=torch.int64, device=device)
        upd = torch.tensor(
            rng.normal(0, 1, (len(ids_np), DIM)).astype(np.float32), device=device)
        before = sorted_scatter_add.launches
        got = sorted_scatter_add(ids, upd, num_rows)
        again = sorted_scatter_add(ids, upd, num_rows)
        torch.cuda.synchronize()
        check(sorted_scatter_add.launches == before + 2, "scatter launches not counted")
        check(got.shape == (num_rows, DIM) and got.dtype == torch.float32)
        check(torch.equal(got, again), f"scatter kernel not deterministic ({name})")
        ref = sorted_scatter_add_plain(ids, upd.double(), num_rows)
        magnitude = sorted_scatter_add_plain(ids, upd.double().abs(), num_rows)
        err = (got.double() - ref).abs()
        check(bool((err <= 1e-6 + 1e-5 * magnitude).all()),
              f"scatter kernel disagrees with its plain version ({name})")
        strict = float((err <= 1e-6 + 1e-5 * ref.abs()).double().mean())
        counts = torch.bincount(ids, minlength=num_rows)
        log(f"  {name}: n={len(ids_np)} rows={num_rows}, longest segment "
            f"{int(counts.max())}, {int((counts == 0).sum())} empty rows: bit-equal "
            f"across two launches, max abs err {float(err.max()):.3e} "
            f"({100 * strict:.4f}% of elements also within 1e-6 + 1e-5 |ref|)")
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
    from kge_tpu_torch.ops.embedding_ops import rows_set, sorted_scatter_add
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

    fused_rank_counts.launches = 0
    sorted_scatter_add.launches = 0
    rows_set.launches = 0


def read_counters():
    from kge_tpu_torch.ops.embedding_ops import rows_set, sorted_scatter_add
    from kge_tpu_torch.ops.rank_kernel import fused_rank_counts

    return {"rank_counts": fused_rank_counts.launches,
            "scatter_add_sorted": sorted_scatter_add.launches,
            "rows_set": rows_set.launches}


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


def tables_of(job):
    return [p.detach().clone() for p in job.optimizer.params]


def one_step_each(folder, checkpoint, key, values):
    """The same step (same state, batch and negatives) under two values of
    one configuration key; returns (tables before, tables after per value,
    the batch, the jobs)."""
    jobs = [resumed_job(folder, checkpoint, **{key: value}) for value in values]
    batch = next(iter(jobs[0]._batches()))
    device = jobs[0].device
    batch = {k: torch.as_tensor(v).to(device) for k, v in batch.items()
             if k != "true_size"}
    batch = jobs[0]._with_negatives(batch)
    before = tables_of(jobs[0])
    after = []
    for job in jobs:
        job._train_step(dict(batch), job._current_lrs())
        after.append(tables_of(job))
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


def time_scatter(seed: int, device):
    """Scatter kernel per call at the three shapes of the dense step; the
    first is the kernels line's."""
    from kge_tpu_torch.ops.embedding_ops import (
        scatter_add_presorted,
        sorted_scatter_add,
        sorted_scatter_add_plain,
    )

    rng = np.random.default_rng(seed + 4)
    out = []
    for name, ids_np, num_rows in scatter_cases(rng)[:3]:
        n = len(ids_np)

        def make():
            return (torch.tensor(ids_np, dtype=torch.int64, device=device),
                    torch.randn(n, DIM, device=device))

        pick = rotating(make)
        ms = time_ms(lambda: sorted_scatter_add(*pick(), num_rows))
        plain_ms = time_ms(lambda: sorted_scatter_add_plain(*pick(), num_rows))
        ids_sorted, order = torch.sort(pick()[0], stable=True)
        kernel_only_ms = time_ms(
            lambda: scatter_add_presorted(ids_sorted, order, pick()[1], num_rows))

        def library():
            ids, upd = pick()
            return torch.zeros(num_rows, DIM, device=device).index_add_(0, ids, upd)

        library_ms = time_ms(library)
        # sorted ids are read by the kernel, the sort itself is outside it
        nbytes = 4.0 * (n * DIM + num_rows * DIM) + 16.0 * n
        flops = float(n * DIM)
        bound_ms = max(nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S) * 1e3
        bound_by = ("bytes" if nbytes / HBM_BYTES_PER_S >= flops / FP32_FLOPS_PER_S
                    else "operations")
        log(f"  scatter_add_sorted {name} n={n} rows={num_rows} D={DIM}: {ms:.4f} ms "
            f"(the wrapper: torch.sort and the kernel; the kernel alone "
            f"{kernel_only_ms:.4f} ms), plain {plain_ms:.4f} ms, library index_add_ "
            f"{library_ms:.4f} ms, bound {bound_ms:.4f} ms ({bound_by})")
        out.append({"shape": name, "n": n, "num_rows": num_rows, "ms": ms,
                    "kernel_only_ms": kernel_only_ms, "plain_ms": plain_ms, "library_ms": library_ms,
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


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("chip_smoke.py: no CUDA card available")

    from kge_tpu_torch import cli
    from kge_tpu_torch.ops import kernel_utils
    from kge_tpu_torch.ops.rank_kernel import (
        csr_row_ids,
        fused_rank_counts,
        fused_rank_counts_plain,
    )

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
        differ_rows = near_rows = total_rows = 0
        for triples, labels in device_batches:
            kernel, _ = job._rank_batch(triples, labels)
            plain, _ = job._rank_batch(triples, labels,
                                       rank_counts=fused_rank_counts_plain)
            fac = job.model.factorized_queries(triples, (0, 2))
            near = {}
            for key, slot, true in (("o", 2, triples[:, 2]), ("s", 0, triples[:, 0])):
                _, q, targets, _ = fac[slot]
                pivot = fused_rank_counts_plain(
                    q, targets, None, labels[key][0], labels[key][1],
                    NUM_ENTITIES, ATOL, RTOL, pivot_cols=true,
                )[3]
                near[key] = boundary_rows(q, targets, pivot, NUM_ENTITIES)
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
        log(f"  second test eval (collated batches reused): wall {warm_wall:.3f} s "
            f"({NUM_TEST / warm_wall:.1f} filtered triples/s)")
        small_eval_agrees(args.seed)

        log("== phase 4: where the time goes, and kernel timings")
        profile = profile_run(job._evaluate, "warm eval")

        triples, labels = device_batches[0]
        pos, q, targets, _ = job.model.factorized_queries(triples, (2,))[2]
        q, targets = q.contiguous(), targets.contiguous()
        row_ptr, cols, _, _ = labels["o"]
        true = triples[:, 2].to(torch.int32).contiguous()
        n, nnz = q.shape[0], cols.numel()
        before = fused_rank_counts.launches
        ms = time_ms(lambda: fused_rank_counts(
            q, targets, None, row_ptr, cols, NUM_ENTITIES, ATOL, RTOL,
            pivot_cols=true))
        check(fused_rank_counts.launches > before)
        plain_ms = time_ms(lambda: fused_rank_counts_plain(
            q, targets, None, row_ptr, cols, NUM_ENTITIES, ATOL, RTOL,
            pivot_cols=true))
        rows = csr_row_ids(row_ptr)

        def library():
            scores = torch.matmul(q, targets.T)
            pivot = scores.gather(1, true.long()[:, None])
            close = torch.isclose(scores, pivot, rtol=RTOL, atol=ATOL)
            greater = (scores > pivot) & ~close
            return greater.sum(1), close.sum(1), scores[rows, cols.long()]

        library_ms = time_ms(library)
        flops = 2.0 * n * NUM_ENTITIES * DIM + 2.0 * n * DIM
        nbytes = 4.0 * (n * DIM + NUM_ENTITIES * DIM + (n + 1) + nnz + n
                        + 3 * n + nnz)
        bound_ms = max(flops / FP32_FLOPS_PER_S, nbytes / HBM_BYTES_PER_S) * 1e3
        bound_by = ("operations" if flops / FP32_FLOPS_PER_S
                    >= nbytes / HBM_BYTES_PER_S else "bytes")
        log(f"  rank_counts n={n} |E|={NUM_ENTITIES} D={DIM} nnz={nnz}: "
            f"{ms:.4f} ms, plain {plain_ms:.4f} ms, library {library_ms:.4f} ms, "
            f"bound {bound_ms:.4f} ms ({bound_by}); {card}")

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

    def entry(name, replaces, count, max_abs_err, times, **more):
        main_shape = times[0]
        return dict(
            name=name, route="cuda", source=f"kge_tpu_torch/csrc/{name}.cu",
            replaces=replaces, launches=count, max_abs_err=max_abs_err,
            ms=main_shape["ms"], plain_ms=main_shape["plain_ms"],
            bound_ms=main_shape["bound_ms"], bound_by=main_shape["bound_by"],
            library_ms=main_shape["library_ms"], **more)

    rank_times = [{"ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
                   "bound_by": bound_by, "library_ms": library_ms}]
    kernels = {"kernels": [
        entry("rank_counts", "kge_tpu/ops/rank_kernel.py:108", launches, max_err,
              rank_times),
        entry("scatter_add_sorted", "kge_tpu/ops/pallas_ops.py:120",
              dense["launches"]["scatter_add_sorted"], scatter_err, scatter_times,
              shapes=scatter_times,
              launches_sparse_epoch=sparse["launches"]["scatter_add_sorted"]),
        entry("rows_set", "kge_tpu/ops/pallas_ops.py:258",
              sparse["launches"]["rows_set"], rows_set_err, rows_set_times,
              shapes=rows_set_times),
    ], "eval_wall_s": wall, "eval_warm_wall_s": warm_wall, "profile": profile,
        "filtered_triples_per_s": NUM_TEST / wall,
        "filtered_triples_per_s_warm": NUM_TEST / warm_wall,
        "train_dense": dense, "train_sparse": sparse,
        "card": card}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
