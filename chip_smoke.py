"""Smoke run of kge_tpu_torch on one CUDA card.

    python3 chip_smoke.py [--seed N]

Phases (any failure exits non-zero; nothing is caught):

1. The card (``nvidia-smi`` name and power limit), torch and CUDA versions,
   and the build of every CUDA kernel of the package from ``csrc/``.
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
4. One ``kernels`` JSON line: per kernel its time per call at the main
   path's shape, launches on the main path, the plain version's and one
   library call's time, and the bound (bytes over 3.35 TB/s or fp32
   operations over 67 TFLOP/s, whichever is larger), with the eval's wall
   time and filtered triples/s.
5. The card's name and power limit, then the ``ok`` JSON line last.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time
import uuid

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12      # H100 SXM data sheet
FP32_FLOPS_PER_S = 67e12       # H100 SXM data sheet, fp32 outside tensor cores
ATOL, RTOL = 1e-5, 1e-4        # entity_ranking.tie_handling defaults

# FB15k-237: entities, relations, train / valid / test triples
FB15K237 = (14541, 237, 272115, 17535, 20466)
NUM_ENTITIES, NUM_TEST = FB15K237[0], FB15K237[4]
DIM, BATCH = 512, 256
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
    """Mean time of ``fn`` on the card by CUDA events, after a warm-up."""
    for _ in range(3):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
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


def profile_eval(job):
    """One warm evaluation under torch.profiler: wall time, device time by
    kernel name, and the device's busy share of the wall."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        start = time.perf_counter()
        job._evaluate()
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
        log(f"  profiled warm eval: wall {wall_ms:.1f} ms, device busy {busy_ms:.1f} ms "
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
    kernel_utils.load_library("rank_counts")
    log(f"  built csrc/rank_counts.cu in {time.perf_counter() - start:.2f} s "
        f"(nvcc {kernel_utils.build_seconds['rank_counts']:.2f} s)")
    for line in kernel_utils.build_log.get("rank_counts", "").splitlines():
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
        profile = profile_eval(job)

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

    kernels = {"kernels": [{
        "name": "rank_counts",
        "route": "cuda",
        "source": "kge_tpu_torch/csrc/rank_counts.cu",
        "replaces": "kge_tpu/ops/rank_kernel.py:108",
        "launches": launches,
        "max_abs_err": max_err,
        "ms": ms,
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": bound_by,
        "library_ms": library_ms,
    }], "eval_wall_s": wall, "eval_warm_wall_s": warm_wall, "profile": profile,
        "filtered_triples_per_s": NUM_TEST / wall,
        "filtered_triples_per_s_warm": NUM_TEST / warm_wall,
        "card": card}
    print(json.dumps(kernels))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))


if __name__ == "__main__":
    main()
