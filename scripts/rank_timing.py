"""Time the rank kernel K1 (kge_tpu_torch/csrc/rank_counts.cu) on one CUDA
card at chip_smoke.py's main shapes: float32 and bfloat16 at n = 256,
|E| = 14,541, D = 512 (random queries and candidates, skewed labels, the
pivot at a random true column), and bfloat16 with the L2 epilogue
(TransE-L2's augmented operands, d = 128, D' = 132; chip_smoke.py
``l2_inputs``); with ``--f16`` the same two 16-bit cases in float16
instead of the three, a third at 1,200 times the scale (about 40% of the
scores past float16's range, an infinity), and the first two over four
column shards (``rank_pivots`` of each summed, each shard's tile launch
against that pivot; hashed after the shards are put together, so the hash
must equal the whole launch's). The whole call by CUDA events (chip_smoke.py
``time_ms``) and each launch from torch.profiler; the 16-bit cases against
the plain version (counts equal, vals and pivots bit for bit), with the
share of entries the certificate left undecided where the kernel reports
it, the tile product alone (``tc_tile_sums``) and the kernel without
labels. ``bits`` is a hash of each case's outputs, so that two builds can
be compared bit for bit.

    python3 scripts/rank_timing.py [--f16] [--root DIR] [--reps N]
                                   [--sass FILE] [--swap OLD=>NEW]...

``--root``: the checkout whose kge_tpu_torch is timed (default: this one;
a ``git archive`` of another commit unpacked under ``build/`` compares the
two in one call: parent, change, change, parent). ``--sass``: write the
root's built library disassembled (``cuobjdump -sass``) to FILE and print
each kernel's count of tensor-core instructions (HMMA, HGMMA). ``--swap``:
also time the 16-bit cases on a copy of rank_counts.cu with the text OLD
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
    parser.add_argument("--f16", action="store_true")
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
    narrow, name = (torch.float16, "float16") if args.f16 else (torch.bfloat16, "bfloat16")
    cases = [
        (name, q32.to(narrow), t32.to(narrow), None, row_ptr, cols, true),
        (f"{name} L2", l2[0].to(narrow).contiguous(), l2[1].to(narrow).contiguous(),
         NEG_SQRT_L2, l2[3], l2[4], l2[5]),
    ]
    if args.f16:
        cases.append(("float16 overflow", (q32 * 1200).half(), (t32 * 1200).half(), None,
                      row_ptr, cols, true))
    else:
        cases.insert(0, ("float32", q32, t32, None, row_ptr, cols, true))
    # the tile product alone: tc_tile_sums, or bf16_tile_sums before float16
    # ran on the tensor cores
    tile_sums = getattr(rank_kernel, "tc_tile_sums", None)
    if tile_sums is None and not args.f16:
        tile_sums = getattr(rank_kernel, "bf16_tile_sums", None)
    for swap in args.swap:
        # ablations: the 16-bit cases on a variant library
        kernel_utils._libraries["rank_counts"] = build_variant(kernel_utils, swap)
        for what, q, t, score_map, rp, cl, tr in cases[-2:]:
            def variant(q=q, t=t, score_map=score_map, rp=rp, cl=cl, tr=tr):
                return fused_rank_counts(q, t, None, rp, cl, E, smoke.ATOL,
                                         smoke.RTOL, score_map=score_map,
                                         pivot_cols=tr)

            product = smoke.kernel_ms(lambda q=q, t=t: tile_sums(q, t),
                                      ["tc_tile_sums_kernel"])["tc_tile_sums_kernel"]
            print(json.dumps({"case": what, "swap": swap,
                              "ms": smoke.time_ms(variant, reps=args.reps),
                              "product_ms": product}), flush=True)
    if args.swap:
        del kernel_utils._libraries["rank_counts"]
        kernel_utils.load_library("rank_counts")
    whole = {}
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
        whole[what] = record["bits"]
        if q.dtype != torch.float32:
            g, c, vals, pivot = fused_rank_counts_plain(
                q, t, None, rp, cl, E, smoke.ATOL, smoke.RTOL, score_map=score_map,
                pivot_cols=tr)
            record["equal_to_plain"] = bool(
                torch.equal(out[0], g) and torch.equal(out[1], c)
                and torch.equal(out[2].view(torch.int16), vals.view(torch.int16))
                and torch.equal(out[3].view(torch.int16), pivot.view(torch.int16)))
            fused_rank_counts.last_recounted = None
            kernel()
            if fused_rank_counts.last_recounted is not None:  # this launch's
                record["recounted"] = int(fused_rank_counts.last_recounted)
                record["recount_share"] = record["recounted"] / (n * E)
        record["ms"] = smoke.time_ms(kernel, reps=args.reps)
        record["launch_ms"] = smoke.kernel_ms(
            kernel, ["rank_prologue_kernel", "rank_tiles", "rank_recount"])
        if q.dtype != torch.float32 and tile_sums is not None:
            # the parts: the tile product alone (and its [n, |E|] float32
            # store), and the kernel without labels
            record["product_ms"] = smoke.kernel_ms(
                lambda q=q, t=t: tile_sums(q, t),
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
    for what, q, t, score_map, rp, cl, tr in cases[:2] if args.f16 else []:
        got = bits(over_shards(rank_kernel, q, t, score_map, rp, cl, tr, 4,
                               smoke.ATOL, smoke.RTOL))
        record = {"root": os.path.abspath(args.root), "case": f"{what} over 4 shards",
                  "bits": got, "equal_to_whole": got == whole[what]}
        print(json.dumps(record), flush=True)
        if not record["equal_to_whole"]:
            print(f"FAILED: {what} over shards", flush=True)
    print(smoke.card_line(), flush=True)


def over_shards(rank_kernel, q, t, score_map, row_ptr, cols, true, shards,
                atol, rtol):
    """(greater, close, vals, pivot) of K1 over ``shards`` column shards of
    t: the pivots of ``rank_pivots`` summed over the shards in float32 (one
    term is the pivot, the others -0.0), each shard's tile launch against
    them, the counts summed and the label values put back in place."""
    E = t.shape[0]
    per = -(-E // shards)
    summed = torch.full((q.shape[0],), -0.0, device=q.device)
    for lo in range(0, E, per):
        summed += rank_kernel.rank_pivots(q, t[lo:lo + per].contiguous(), true, lo,
                                          score_map=score_map).float()
    pivot = summed.to(q.dtype)
    rows = rank_kernel.csr_row_ids(row_ptr)
    g = torch.zeros(q.shape[0], dtype=torch.int32, device=q.device)
    c = torch.zeros_like(g)
    vals = torch.zeros(cols.numel(), dtype=q.dtype, device=q.device)
    for lo in range(0, E, per):
        hi = min(E, lo + per)
        keep = (cols >= lo) & (cols < hi)
        ptr = torch.zeros_like(row_ptr)
        ptr[1:] = torch.cumsum(torch.bincount(rows[keep], minlength=q.shape[0]), 0)
        gm, cm, vm, _ = rank_kernel.fused_rank_counts(
            q, t[lo:hi].contiguous(), pivot, ptr, (cols[keep] - lo).contiguous(),
            hi - lo, atol, rtol, score_map=score_map)
        g += gm
        c += cm
        vals[keep] = vm
    return g, c, vals, pivot


if __name__ == "__main__":
    main()
