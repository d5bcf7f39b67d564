"""Time the rank kernel K1 (kge_tpu_torch/csrc/rank_counts.cu) on one CUDA
card at chip_smoke.py's main shapes: float32 and bfloat16 at n = 256,
|E| = 14,541, D = 512 (random queries and candidates, skewed labels, the
pivot at a random true column), and bfloat16 with the L2 epilogue
(TransE-L2's augmented operands, d = 128, D' = 132; chip_smoke.py
``l2_inputs``). The whole call by CUDA events (chip_smoke.py ``time_ms``)
and each launch from torch.profiler; the bfloat16 cases against the plain
version (counts equal, vals and pivots bit for bit), with the share of
entries the certificate left undecided where the kernel reports it, the
tile product alone (``bf16_tile_sums``) and the kernel without labels.
``bits`` is a hash of each case's outputs, so that two builds can be
compared bit for bit.

    python3 scripts/rank_timing.py [--root DIR] [--reps N] [--sass FILE]
                                   [--swap OLD=>NEW]...

``--root``: the checkout whose kge_tpu_torch is timed (default: this one;
a ``git archive`` of another commit unpacked under ``build/`` compares the
two in one call: parent, change, change, parent). ``--sass``: write the
root's built library disassembled (``cuobjdump -sass``) to FILE and print
each kernel's count of tensor-core instructions (HMMA, HGMMA). ``--swap``:
also time the bfloat16 cases on a copy of rank_counts.cu with the text OLD
replaced by NEW (an ablation, such as a part of the epilogue taken out, to
see what binds the time; its results are wrong by design); several
replacements are joined by ``|||``; may be repeated. Prints one JSON line
per case, then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import shutil
import subprocess
import sys

import numpy as np
import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


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


def sass_counts(path: str, out: str) -> dict:
    """Tensor-core instructions of each kernel in the library at ``path``."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    sass = subprocess.run([tool, "-sass", path], capture_output=True, text=True,
                          check=True).stdout
    with open(out, "w") as f:
        f.write(sass)
    counts = {}
    for section in re.split(r"\n\s*Function : ", sass)[1:]:
        name, body = section.split("\n", 1)
        counts[name.strip()] = {"HMMA": len(re.findall(r"\bHMMA\b", body)),
                                "HGMMA": len(re.findall(r"\bHGMMA\b", body))}
    return counts


def build_variant(kernel_utils, swap: str) -> ctypes.CDLL:
    """The root's rank_counts.cu with each OLD of ``swap`` replaced by NEW,
    built beside the kernels and loaded."""
    with open(os.path.join(kernel_utils.CSRC_DIR, "rank_counts.cu")) as f:
        source = f.read()
    for pair in swap.split("|||"):
        old, new = pair.split("=>")
        if old not in source:
            raise SystemExit(f"rank_counts.cu has no {old!r}")
        source = source.replace(old, new)
    folder = os.path.join(kernel_utils.BUILD_DIR, "variants")
    os.makedirs(folder, exist_ok=True)
    stem = os.path.join(folder, "rank_counts_" + hashlib.sha1(swap.encode()).hexdigest()[:12])
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
    parser.add_argument("--sass", default=None)
    parser.add_argument("--swap", action="append", default=[])
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("rank_timing.py: no CUDA card available")
    sys.path.insert(0, os.path.abspath(args.root))
    from kge_tpu_torch.ops import kernel_utils, rank_kernel
    from kge_tpu_torch.ops.rank_kernel import (
        NEG_SQRT_L2,
        fused_rank_counts,
        fused_rank_counts_plain,
    )

    smoke = load_smoke()
    device = torch.device("cuda")
    torch.backends.cuda.matmul.allow_tf32 = False
    path = kernel_utils.build("rank_counts")
    for line in kernel_utils.build_log.get("rank_counts", "").splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            print("  " + line.strip(), flush=True)
    if args.sass:
        for name, c in sass_counts(path, args.sass).items():
            print(json.dumps({"kernel": name, **c}), flush=True)

    rng = np.random.default_rng(22)
    E, n, D = smoke.NUM_ENTITIES, smoke.BATCH, smoke.DIM
    q32 = torch.tensor(rng.normal(0, 0.05, (n, D)).astype(np.float32), device=device)
    t32 = torch.tensor(rng.normal(0, 0.05, (E, D)).astype(np.float32), device=device)
    true_np = rng.integers(0, E, n).astype(np.int32)
    row_ptr, cols = smoke.skewed_labels(rng, n, E, device, true=true_np)
    true = torch.tensor(true_np, device=device)
    l2 = smoke.l2_inputs(0, device)
    cases = [
        ("float32", q32, t32, None, row_ptr, cols, true),
        ("bfloat16", q32.bfloat16(), t32.bfloat16(), None, row_ptr, cols, true),
        ("bfloat16 L2", l2[0].bfloat16().contiguous(), l2[1].bfloat16().contiguous(),
         NEG_SQRT_L2, l2[3], l2[4], l2[5]),
    ]
    for swap in args.swap:
        # ablations: the bfloat16 cases on a variant library
        kernel_utils._libraries["rank_counts"] = build_variant(kernel_utils, swap)
        for what, q, t, score_map, rp, cl, tr in cases[1:]:
            def variant(q=q, t=t, score_map=score_map, rp=rp, cl=cl, tr=tr):
                return fused_rank_counts(q, t, None, rp, cl, E, smoke.ATOL,
                                         smoke.RTOL, score_map=score_map,
                                         pivot_cols=tr)

            product = smoke.kernel_ms(lambda q=q, t=t: rank_kernel.bf16_tile_sums(q, t),
                                      ["tc_tile_sums_kernel"])["tc_tile_sums_kernel"]
            print(json.dumps({"case": what, "swap": swap,
                              "ms": smoke.time_ms(variant, reps=args.reps),
                              "product_ms": product}), flush=True)
    if args.swap:
        del kernel_utils._libraries["rank_counts"]
        kernel_utils.load_library("rank_counts")
    for what, q, t, score_map, rp, cl, tr in cases:
        def kernel(q=q, t=t, score_map=score_map, rp=rp, cl=cl, tr=tr):
            return fused_rank_counts(q, t, None, rp, cl, E, smoke.ATOL, smoke.RTOL,
                                     score_map=score_map, pivot_cols=tr)

        out = kernel()
        second = kernel()
        torch.cuda.synchronize()
        same = bits(out) == bits(second)
        record = {"root": os.path.abspath(args.root), "case": what,
                  "shape": [n, E, q.shape[1], cl.numel()], "bits": bits(out),
                  "two_launches_equal": same}
        if q.dtype == torch.bfloat16:
            g, c, vals, pivot = fused_rank_counts_plain(
                q, t, None, rp, cl, E, smoke.ATOL, smoke.RTOL, score_map=score_map,
                pivot_cols=tr)
            record["equal_to_plain"] = bool(
                torch.equal(out[0], g) and torch.equal(out[1], c)
                and torch.equal(out[2].view(torch.int16), vals.view(torch.int16))
                and torch.equal(out[3].view(torch.int16), pivot.view(torch.int16)))
            recounted = getattr(fused_rank_counts, "last_recounted", None)
            if recounted is not None:
                kernel()
                record["recounted"] = int(fused_rank_counts.last_recounted)
                record["recount_share"] = record["recounted"] / (n * E)
        record["ms"] = smoke.time_ms(kernel, reps=args.reps)
        record["launch_ms"] = smoke.kernel_ms(
            kernel, ["rank_prologue_kernel", "rank_tiles", "rank_recount"])
        if q.dtype == torch.bfloat16 and hasattr(rank_kernel, "bf16_tile_sums"):
            # the parts: the tile product alone (and its [n, |E|] float32
            # store), and the kernel without labels
            record["product_ms"] = smoke.kernel_ms(
                lambda q=q, t=t: rank_kernel.bf16_tile_sums(q, t),
                ["tc_tile_sums_kernel"])["tc_tile_sums_kernel"]
            empty = (torch.zeros_like(rp), cl[:0])
            record["no_labels_ms"] = smoke.kernel_ms(
                lambda: fused_rank_counts(q, t, None, *empty, E, smoke.ATOL,
                                          smoke.RTOL, score_map=score_map,
                                          pivot_cols=tr),
                ["rank_tiles"])["rank_tiles"]
        print(json.dumps(record), flush=True)
        if not same or not record.get("equal_to_plain", True):
            print(f"FAILED: {what}", flush=True)
    print(smoke.card_line(), flush=True)


if __name__ == "__main__":
    main()
