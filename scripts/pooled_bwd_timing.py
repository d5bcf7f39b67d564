"""Time the pooled-distance kernels of kge_tpu_torch/csrc/dist_pool.cu on
one CUDA card, at the shapes of chip_smoke.py phase 13: by default the
backward (K5b: ``pooled_dq_kernel`` and ``pooled_dpool_kernel``), with
``--forward`` the forward (K5a: ``pooled_scores_kernel``), there also with
the ``cmod`` pool parts as the column halves of one table (row stride 2 d,
as the model passes them). The whole call by CUDA events (chip_smoke.py
``time_ms``) and each launch from torch.profiler, and the result against
the plain version in float64 (phase 10's rule; the forward's rows whose
query equals a candidate also within ``1.01e-15 d`` of 0 at ``cmod``, and
exactly 0 at ``l1``; ``bits`` is a hash of its scores, so that two builds
can be compared bit for bit). With ``--bf16`` the bfloat16 path instead,
forward and backward, at P-rotate's ``cmod`` shape and P-transe's two
``l1`` shapes, against the plain version in bfloat16 (chip_smoke.py phase
22's rule: scores within one bfloat16 ulp, dq and dpool within one ulp plus
2^-12 of the summed factor magnitudes, NaN and +-inf in the same places);
with ``--f16`` the float16 path the same way, with phase 22's zero
distances and underflowing squares (``f16_underflow_block``) at ``cmod``.
Both print a hash of each output (``bits``: scores, dq, dpool), so that
two trees compare bit for bit.

    python3 scripts/pooled_bwd_timing.py [--forward | --bf16 | --f16] [--root DIR]
                                         [--variant NAME=V,NAME=V]...
                                         [--swap OLD=>NEW]... [--sass FILE]

``--root``: the checkout whose kge_tpu_torch is timed (default: this one),
so that two trees can be compared in one process. ``--variant``: also time
the root's kernels with those constants replaced (the tile sizes); may be
repeated. A NAME of ops/dist_pool.py (``DPOOL_BLOCKS``) is set there for
that run; any other is a ``constexpr int`` of dist_pool.cu, built into a
copy. ``--swap``: also time a copy with the text OLD replaced by NEW (an
ablation, such as an instruction taken out, to see what binds the time;
its results are wrong by design); several replacements are joined by
``|||``. ``--sass``: write the root's built
library disassembled (``cuobjdump -sass``) to FILE and print each kernel's
instruction count, its special-function (MUFU) instructions, and each of
its innermost loops that holds one: its instructions and MUFUs, from which
the instructions a pair element follow. Prints one JSON line per (variant,
shape), then the card's name and power limit.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import importlib.util
import json
import os
import re
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

import torch

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def load_smoke():
    spec = importlib.util.spec_from_file_location(
        "chip_smoke", os.path.join(HERE, "chip_smoke.py"))
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def build_variant(kernel_utils, settings: dict, swap=None) -> str:
    """A library of the root's dist_pool.cu with ``settings`` replacing its
    ``constexpr int`` constants and, with ``swap`` ("OLD=>NEW"), the text
    OLD replaced by NEW; the compiler's resource report is printed."""
    with open(os.path.join(kernel_utils.CSRC_DIR, "dist_pool.cu")) as f:
        source = f.read()
    for pair in swap.split("|||") if swap else ():
        old, new = pair.split("=>")
        if old not in source:
            raise SystemExit(f"dist_pool.cu has no {old!r}")
        source = source.replace(old, new)
    for name, value in settings.items():
        source, count = re.subn(rf"(constexpr int {name} = )[^;]+;",
                                rf"\g<1>{value};", source)
        if count != 1:
            raise SystemExit(f"dist_pool.cu has no 'constexpr int {name}'")
    label = ",".join(f"{k}={v}" for k, v in settings.items()) or swap
    folder = os.path.join(kernel_utils.BUILD_DIR, "variants")
    os.makedirs(folder, exist_ok=True)
    cu = os.path.join(folder, f"dist_pool_{hashlib.sha1(label.encode()).hexdigest()[:12]}.cu")
    with open(cu, "w") as f:
        f.write(source)
    so = cu[:-3] + ".so"
    proc = subprocess.run(
        [kernel_utils._nvcc()] + kernel_utils.NVCC_FLAGS
        + ["-I", kernel_utils.CSRC_DIR, "-o", so, cu],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise SystemExit(f"nvcc failed for {label}:\n{proc.stderr}")
    report = [line.strip() for line in (proc.stdout + proc.stderr).splitlines()
              if "registers" in line or "spill" in line]
    print(f"{label}: " + " | ".join(report), flush=True)
    return so


def time_case(smoke, dist_pool, case, device, seed: int):
    name, kind, n, K, F, d = case[:6]
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    queries, pools, sel = smoke.pooled_inputs(kind, n, K, F, d, generator, device)
    g = torch.randn(n, K, generator=generator, device=device)

    def backward():
        return dist_pool._launch_backward(queries, pools, sel, g, F, kind)

    ms = smoke.time_ms(backward, reps=20)
    split = smoke.kernel_ms(backward, ("pooled_dq_kernel", "pooled_dpool_kernel"))
    dqs, dpools = backward()
    first = [t.clone() for t in dqs + dpools]
    dqs, dpools = backward()
    same_bits = all(torch.equal(a, b) for a, b in zip(first, dqs + dpools))
    _, ref_dqs, ref_dpools, mag_q, mag_pool = smoke.pooled_reference(
        queries, pools, sel, F, kind, g)
    err, within = 0.0, True
    for got, want, mag in ([(a, b, mag_q) for a, b in zip(dqs, ref_dqs)]
                           + [(a, b, mag_pool) for a, b in zip(dpools, ref_dpools)]):
        e = (got.double() - want).abs()
        err = max(err, float(e.max()))
        within = within and bool((e <= 1e-6 + 1e-5 * mag[:, None]).all())
    return {"shape": name, "kind": kind, "n": n, "K": K, "F": F, "d": d, "ms": ms,
            "dq_ms": split["pooled_dq_kernel"], "dpool_ms": split["pooled_dpool_kernel"],
            "max_abs_err": err, "within_tolerance": within, "bit_equal": same_bits}


def time_forward(smoke, dist_pool, case, device, seed: int, stride_parts: bool):
    name, kind, n, K, F, d = case[:6]
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    queries, pools, sel = smoke.pooled_inputs(kind, n, K, F, d, generator, device,
                                              stride_parts)

    def forward():
        return dist_pool._launch_forward(queries, pools, sel, F, kind)

    ms = smoke.time_ms(forward, reps=20)
    kernel = smoke.kernel_ms(forward, ("pooled_scores",))["pooled_scores"]
    out = forward().clone()
    same_bits = torch.equal(out, forward())
    g = torch.zeros(n, K, device=device)
    ref = smoke.pooled_reference(queries, pools, sel, F, kind, g)[0]
    e = (out.double() - ref).abs()
    within = bool((e <= 1e-6 + 1e-5 * ref.abs()).all())
    # the rows pooled_inputs gave a query equal to a candidate
    rows = torch.arange(0, n, max(1, n // 7), device=device)
    zero = out[rows, rows % K].abs()
    zero_ok = bool((zero <= 1.01e-15 * d).all() if kind == "cmod" else (zero == 0).all())
    return {"shape": name + (" (parts as column halves)" if stride_parts else ""),
            "kind": kind, "n": n, "K": K, "F": F, "d": d,
            "ldp": pools[0].stride(0), "ms": ms, "kernel_ms": kernel,
            "max_abs_err": float(e.max()), "within_tolerance": within,
            "zero_distance_ok": zero_ok, "bit_equal": same_bits,
            "bits": hashlib.sha1(out.cpu().numpy().tobytes()).hexdigest()[:16]}


def bits_of(tensors) -> str:
    """A hash of the tensors' bytes, in order."""
    digest = hashlib.sha1()
    for t in tensors:
        digest.update(t.detach().contiguous().view(torch.uint8).cpu().numpy().tobytes())
    return digest.hexdigest()[:16]


def time_16(smoke, dist_pool, case, device, seed: int, dtype):
    """The bfloat16 or float16 forward and backward of one shape: the whole
    call by CUDA events, each launch from the profiler, both against the
    plain version, two launches bit for bit, and the outputs' hashes."""
    name, kind, n, K, F, d = case[:6]
    generator = torch.Generator(device=device)
    generator.manual_seed(seed)
    queries, pools, sel = smoke.pooled_inputs(kind, n, K, F, d, generator, device)
    leaves = [x.to(dtype) for x in queries + pools]
    parts = len(queries)
    if dtype == torch.float16 and kind == "cmod":
        smoke.f16_underflow_block(leaves, sel, F)
    queries, pools = leaves[:parts], leaves[parts:]
    g = torch.randn(n, K, generator=generator, device=device).to(dtype)

    def forward():
        return dist_pool._launch_forward(queries, pools, sel, F, kind)

    def backward():
        return dist_pool._launch_backward(queries, pools, sel, g, F, kind)

    fwd_ms = smoke.time_ms(forward, reps=20)
    bwd_ms = smoke.time_ms(backward, reps=20)
    fwd_split = smoke.kernel_ms(forward, ("pooled_scores",))
    bwd_split = smoke.kernel_ms(backward, ("pooled_dq", "pooled_dpool"))
    out = forward()
    dqs, dpools = backward()
    first = [t.clone() for t in [out] + dqs + dpools]
    dqs, dpools = backward()
    same_bits = all(torch.equal(a, b) for a, b in zip(first, [forward()] + dqs + dpools))
    leaves = [t.clone().requires_grad_(True) for t in queries + pools]
    ref = dist_pool.pooled_dist_scores_plain(leaves[:parts], leaves[parts:], sel, F, kind)
    ref_grads = torch.autograd.grad(ref, leaves, g)
    ulp = 2.0 ** -7 if dtype == torch.bfloat16 else 2.0 ** -10
    ref = ref.detach()
    fwd_ok = smoke.same_non_finite_within(out, ref, 1e-6 + ulp * ref.float().abs())
    e = (out.float() - ref.float())[torch.isfinite(ref)].abs()
    rows = (torch.arange(K, device=device)[None, :] * F + sel.long()).reshape(-1)
    dq_mag = 2 * g.float().abs().sum(1, keepdim=True)
    dpool_mag = torch.zeros(K * F, 1, device=device).index_add_(
        0, rows, 2 * g.float().abs().reshape(-1, 1))
    bwd_err, bwd_ok, non_finite = 0.0, True, 0
    for i, (got, want) in enumerate(zip(dqs + dpools, ref_grads)):
        mag = dq_mag if i < parts else dpool_mag
        finite = torch.isfinite(want)
        non_finite += int((~finite).sum())
        bwd_err = max(bwd_err, float((got.float() - want.float())[finite].abs().max()))
        bwd_ok = bwd_ok and smoke.same_non_finite_within(
            got, want, 1e-6 + ulp * want.float().abs() + 2.0 ** -12 * mag)
    return {"shape": name, "kind": kind, "n": n, "K": K, "F": F, "d": d,
            "dtype": str(dtype).split(".")[-1], "fwd_ms": fwd_ms,
            "fwd_kernel_ms": fwd_split["pooled_scores"], "bwd_ms": bwd_ms,
            "dq_ms": bwd_split["pooled_dq"], "dpool_ms": bwd_split["pooled_dpool"],
            "fwd_max_abs_err": float(e.max()), "fwd_within_tolerance": fwd_ok,
            "bwd_max_abs_err": bwd_err, "bwd_within_tolerance": bwd_ok,
            "non_finite_gradient_entries": non_finite, "bit_equal": same_bits,
            "bits": {"scores": bits_of([out]), "dq": bits_of(dqs),
                     "dpool": bits_of(dpools)}}


def sass_report(sass: str):
    """Per kernel of a ``cuobjdump -sass`` listing: its instructions, its
    MUFU instructions by kind, and each innermost loop that holds a MUFU (a
    backward branch with no other such loop inside; loops without a MUFU,
    such as a stage's copies, may lie inside): its length in instructions
    and its MUFUs. Yields one line each."""
    line = re.compile(r"^\s+/\*([0-9a-f]{4,})\*/\s+(.*?)\s*;", re.M)
    for function in sass.split("Function : ")[1:]:
        name = function.split()[0]
        code = [(int(a, 16), text) for a, text in line.findall(function)]
        kinds = {}
        for _, text in code:
            if "MUFU." in text:
                op = "MUFU." + text.split("MUFU.")[1].split()[0]
                kinds[op] = kinds.get(op, 0) + 1
        yield f"sass: {len(code)} instructions, MUFU {kinds} in {name}"
        back = []
        for k, (addr, text) in enumerate(code):
            target = re.search(r"BRA(?:\.\S+)? (?:`\(\.L_x_\d+\) )?0x([0-9a-f]+)", text)
            if target and int(target.group(1), 16) <= addr:
                start = next(i for i, (a, _) in enumerate(code)
                             if a >= int(target.group(1), 16))
                back.append((start, k))
        back = [(s2, e2) for s2, e2 in back
                if any("MUFU." in text for _, text in code[s2:e2 + 1])]
        for start, end in back:
            if any(start <= s2 and e2 < end and (s2, e2) != (start, end)
                   for s2, e2 in back):
                continue
            body = [text for _, text in code[start:end + 1]]
            yield (f"sass loop: {len(body)} instructions, "
                   f"{sum('MUFU.' in t for t in body)} MUFU "
                   f"({sum('MUFU.SQRT' in t for t in body)} SQRT, "
                   f"{sum('MUFU.RCP' in t for t in body)} RCP, "
                   f"{sum('MUFU.RSQ' in t for t in body)} RSQ) in {name}")


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--forward", action="store_true")
    parser.add_argument("--bf16", action="store_true")
    parser.add_argument("--f16", action="store_true")
    parser.add_argument("--root", default=HERE)
    parser.add_argument("--variant", action="append", default=[])
    parser.add_argument("--swap", action="append", default=[])
    parser.add_argument("--sass")
    parser.add_argument("--seed", type=int, default=0)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        sys.exit("pooled_bwd_timing.py: no CUDA card available")
    sys.path.insert(0, os.path.abspath(args.root))
    from kge_tpu_torch.ops import dist_pool, kernel_utils

    smoke = load_smoke()
    device = torch.device("cuda")
    default_lib = kernel_utils.load_library("dist_pool")
    if args.sass:
        cuobjdump = os.path.join(os.path.dirname(kernel_utils._nvcc()), "cuobjdump")
        sass = subprocess.run([cuobjdump, "-sass", kernel_utils.library_path("dist_pool")],
                              capture_output=True, text=True, check=True).stdout
        with open(args.sass, "w") as f:
            f.write(sass)
        for report in sass_report(sass):
            print(report, flush=True)
    for line in kernel_utils.build_log.get("dist_pool", "").splitlines():
        if "entry function" in line or "registers" in line or "stack frame" in line:
            print("default: " + line.strip(), flush=True)
    # (label, constants of ops/dist_pool.py, constants of dist_pool.cu, swap)
    runs = [("default", {}, {}, None)]
    for variant in args.variant:
        pairs = dict(item.split("=") for item in variant.split(","))
        py = {k: int(v) for k, v in pairs.items() if hasattr(dist_pool, k)}
        runs.append((variant, py, {k: v for k, v in pairs.items() if k not in py},
                     None))
    runs += [(f"swap {swap}", {}, {}, swap) for swap in args.swap]
    with ThreadPoolExecutor(max(1, len(runs))) as pool:
        libs = list(pool.map(
            lambda run: ctypes.CDLL(build_variant(kernel_utils, run[2], run[3]))
            if run[2] or run[3] else default_lib, runs))
    cases = [(smoke.POOLED_CASES[2], False), (smoke.POOLED_CASES[0], False),
             (smoke.POOLED_CASES[1], False)]
    if args.forward:
        cases.insert(1, (smoke.POOLED_CASES[2], True))
    defaults = {k: getattr(dist_pool, k) for _, py, _, _ in runs for k in py}
    for (label, py, _, _), lib in zip(runs, libs):
        kernel_utils._libraries["dist_pool"] = lib
        for k, v in {**defaults, **py}.items():
            setattr(dist_pool, k, v)
        for case, stride_parts in cases:
            if args.bf16 or args.f16:
                row = time_16(smoke, dist_pool, case, device, args.seed + 10,
                              torch.bfloat16 if args.bf16 else torch.float16)
            elif args.forward:
                row = time_forward(smoke, dist_pool, case, device, args.seed + 10,
                                   stride_parts)
            else:
                row = time_case(smoke, dist_pool, case, device, args.seed + 10)
            print(json.dumps({"root": os.path.abspath(args.root), "build": label,
                              **row}), flush=True)
    print(smoke.card_line())


if __name__ == "__main__":
    main()
