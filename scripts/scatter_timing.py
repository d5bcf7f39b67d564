"""Time the scatter kernel K2 (kge_tpu_torch/csrc/scatter_add_sorted.cu) on
one CUDA card, in float32 and in bfloat16, at the five shapes of
chip_smoke.py ``time_scatter``: 8,192 power-law entity ids into [14,541,
512] (the main shape), relation lookups (8,192 ids into 237 rows), 129
shared targets, the entity lookups at d = 128, and T-sparse's 16,642 row
ids into 200,000 rows. For each case: the whole call by CUDA events
(chip_smoke.py ``time_ms``), the host's time to enqueue a call, each
launch from torch.profiler, launch A (the sort) and launch B (the sums)
alone by CUDA events, the segment sums (``sorted_segment_sums``), their
launch A alone, and ``index_add_`` in the same dtype. ``bits`` is a hash of the case's outputs (the scatter-add, the
sorted keys, order and segment numbers of ``work``, the segment sums), so
that two builds can be compared bit for bit. Then the sort's route at
17,409, 524,288 and 1,000,000 ids: the kernel's own sort (launch A) where
the build takes that many, against the wrapper's stable ``torch.sort``
followed by launch A on the sort it gives.

    python3 scripts/scatter_timing.py [--root DIR] [--reps N]
                                      [--swap OLD=>NEW]...

``--root``: the checkout whose kge_tpu_torch is timed (default: this one;
a ``git archive`` of another commit unpacked under ``build/`` compares the
two in one call: parent, change, change, parent). ``--swap``: time the
cases instead on a copy of scatter_add_sorted.cu with the text OLD
replaced by NEW (an ablation, such as the grid barriers taken out, to see
what binds the time; its results may be wrong by design, so their checks
do not count); several replacements are joined by ``|||``; may be
repeated. Inputs come from numpy seeds, so every root sees the same ones.
Prints one JSON line per case, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# launch A's kernel holds "sort" in its name in every build, launch B's is
# segment_sums_kernel
LAUNCHES = ("sort", "segment_sums_kernel")


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def bits(tensors) -> str:
    digest = hashlib.sha1()
    for x in tensors:
        digest.update(x.contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def cases(smoke):
    """(name, ids, num_rows, D): chip_smoke.py ``time_scatter``'s five."""
    rng = np.random.default_rng(4)
    dense = smoke.scatter_cases(rng)[:3]
    return [case + (smoke.DIM,) for case in dense] + [
        ("entity lookups, d = 128",
         smoke.power_law_ids(rng, smoke.NUM_ENTITIES, smoke.TRAIN_BATCH, 0.8),
         smoke.NUM_ENTITIES, smoke.TRANSE_DIM),
        ("row-sparse entity ids", smoke.rows_set_cases(rng)[0][2],
         smoke.SPARSE_ENTITIES, smoke.DIM),
    ]


def time_case(smoke, ops, name, ids_np, num_rows, D, dtype, reps, device):
    n = len(ids_np)
    rng = np.random.default_rng(n + D)
    sets = [(torch.tensor(ids_np, dtype=torch.int64, device=device),
             torch.tensor(rng.normal(0, 1, (n, D)).astype(np.float32),
                          device=device).to(dtype))
            for _ in range(4)]
    state = {"i": 0}

    def pick():
        state["i"] = (state["i"] + 1) % len(sets)
        return sets[state["i"]]

    ids, upd = sets[0]
    out = ops.sorted_scatter_add(ids, upd, num_rows)
    again = ops.sorted_scatter_add(ids, upd, num_rows)
    buffers = ops.scatter_launch(ids, None, upd, num_rows)
    rs, seg, gsum = ops.sorted_segment_sums(ids, upd, num_rows)
    torch.cuda.synchronize()
    record = {"case": name, "dtype": str(dtype).replace("torch.", ""), "n": n,
              "num_rows": num_rows, "dim": D,
              "bits": bits([out, buffers[1][:3 * n], rs, seg, gsum]),
              "two_launches_equal": bool(torch.equal(out, again))}
    record["ms"] = smoke.time_ms(lambda: ops.sorted_scatter_add(*pick(), num_rows),
                                 reps=reps)
    # the host's cost of a call: enqueued while the card waits behind a spin
    # kernel, so that the card never holds the host back
    torch.cuda.synchronize()
    torch.cuda._sleep(smoke.SPIN_CYCLES)
    start = time.perf_counter()
    for _ in range(200):
        ops.sorted_scatter_add(*pick(), num_rows)
    record["host_us"] = (time.perf_counter() - start) / 200 * 1e6
    torch.cuda.synchronize()
    record["launch_ms"] = smoke.kernel_ms(
        lambda: ops.sorted_scatter_add(ids, upd, num_rows), list(LAUNCHES))
    record["launch_a_ms"] = smoke.time_ms(lambda: ops.scatter_launch(
        pick()[0], None, upd, num_rows, phases=1, buffers=buffers), reps=reps)
    record["launch_b_ms"] = smoke.time_ms(lambda: ops.scatter_launch(
        ids, None, pick()[1], num_rows, phases=2, buffers=buffers), reps=reps)
    record["segment_sums_ms"] = smoke.time_ms(
        lambda: ops.sorted_segment_sums(*pick(), num_rows), reps=reps)
    by_segment = ops.scatter_launch(ids, None, upd, num_rows, by_segment=True)
    record["sort_alone_ms"] = smoke.time_ms(lambda: ops.scatter_launch(
        pick()[0], None, upd, num_rows, by_segment=True, phases=1,
        buffers=by_segment), reps=reps)

    def library():
        ids, upd = pick()
        return torch.zeros(num_rows, D, dtype=dtype, device=device).index_add_(
            0, ids, upd)

    record["library_ms"] = smoke.time_ms(library, reps=reps)
    record["bound_ms"] = (upd.element_size() * (n * D + num_rows * D) + 8.0 * n) \
        / smoke.HBM_BYTES_PER_S * 1e3
    return record


def time_route(smoke, ops, n, device, reps):
    """The kernel's own sort against a stable torch.sort and launch A on it,
    at ``n`` power-law ids into 200,000 rows."""
    rng = np.random.default_rng(n)
    num_rows = smoke.SPARSE_ENTITIES
    ids = torch.tensor(smoke.power_law_ids(rng, num_rows, n, 0.8), device=device)
    upd = torch.zeros(n, 8, device=device)
    record = {"case": "sort route", "n": n, "num_rows": num_rows,
              "route": ops.sort_route(n)}

    def torch_route():
        keys, order = torch.sort(ids, stable=True)
        return ops.scatter_launch(keys, order, upd, num_rows, by_segment=True,
                                  phases=1)

    record["torch_sort_ms"] = smoke.time_ms(
        lambda: torch.sort(ids, stable=True), reps=reps)
    record["torch_route_sort_ms"] = smoke.time_ms(torch_route, reps=reps)
    try:
        ops.scatter_launch(ids, None, upd, num_rows, by_segment=True, phases=1)
    except ValueError:
        record["kernel_sort_ms"] = None  # this build's kernel sorts fewer
    else:
        record["kernel_sort_ms"] = smoke.time_ms(lambda: ops.scatter_launch(
            ids, None, upd, num_rows, by_segment=True, phases=1), reps=reps)
        _, work, _ = ops.scatter_launch(ids, None, upd, num_rows, by_segment=True,
                                        phases=1)
        keys, order = torch.sort(ids, stable=True)
        record["equal_to_torch_sort"] = bool(
            torch.equal(work[:n].long(), keys) and torch.equal(work[n:2 * n].long(), order))
    return record


def build_variant(kernel_utils, swap: str) -> ctypes.CDLL:
    """The root's scatter_add_sorted.cu with each OLD of ``swap`` replaced
    by NEW, built beside the kernels and loaded."""
    with open(os.path.join(kernel_utils.CSRC_DIR, "scatter_add_sorted.cu")) as f:
        source = f.read()
    for pair in swap.split("|||"):
        old, new = pair.split("=>")
        if old not in source:
            raise SystemExit(f"scatter_add_sorted.cu has no {old!r}")
        source = source.replace(old, new)
    folder = os.path.join(kernel_utils.BUILD_DIR, "variants")
    os.makedirs(folder, exist_ok=True)
    stem = os.path.join(folder, "scatter_add_sorted_"
                        + hashlib.sha1(swap.encode()).hexdigest()[:12])
    with open(stem + ".cu", "w") as f:
        f.write(source)
    subprocess.run([kernel_utils._nvcc()] + kernel_utils.NVCC_FLAGS
                   + ["-I", kernel_utils.CSRC_DIR, "-o", stem + ".so", stem + ".cu"],
                   check=True, capture_output=True)
    return ctypes.CDLL(stem + ".so")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--reps", type=int, default=100)
    parser.add_argument("--swap", action="append", default=[])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("scatter_timing.py: no CUDA card available")
    sys.path.insert(0, os.path.abspath(args.root))
    from kge_tpu_torch.ops import embedding_ops as ops
    from kge_tpu_torch.ops import kernel_utils

    smoke = load_smoke()
    device = torch.device("cuda")
    kernel_utils.build("scatter_add_sorted")
    for line in kernel_utils.build_log.get("scatter_add_sorted", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip(), flush=True)
    for swap in args.swap:
        # ablations: every case on a variant library
        kernel_utils._libraries["scatter_add_sorted"] = build_variant(kernel_utils, swap)
        for name, ids_np, num_rows, D in cases(smoke):
            for dtype in (torch.float32, torch.bfloat16):
                record = time_case(smoke, ops, name, ids_np, num_rows, D, dtype,
                                   args.reps, device)
                print(json.dumps({"swap": swap, **record}), flush=True)
    if args.swap:
        del kernel_utils._libraries["scatter_add_sorted"]
        kernel_utils.load_library("scatter_add_sorted")
    failed = False
    for name, ids_np, num_rows, D in cases(smoke):
        for dtype in (torch.float32, torch.bfloat16):
            record = time_case(smoke, ops, name, ids_np, num_rows, D, dtype,
                               args.reps, device)
            record["root"] = os.path.abspath(args.root)
            print(json.dumps(record), flush=True)
            failed |= not record["two_launches_equal"]
    for n in (17409, 2 ** 19, 10 ** 6):
        record = time_route(smoke, ops, n, device, args.reps)
        record["root"] = os.path.abspath(args.root)
        print(json.dumps(record), flush=True)
        failed |= not record.get("equal_to_torch_sort", True)
    print(smoke.card_line(), flush=True)
    if failed:
        sys.exit("scatter_timing.py: a check failed")


if __name__ == "__main__":
    main()
