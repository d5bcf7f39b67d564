"""How many host-to-card copies ``torch.profiler`` reports for copies whose
number is known: ``--copies`` pageable copies (``tensor.to("cuda")``) of an
int64 array of each size, each under its own profile, alone and as the
first work of a profile that then launches kernels.

    python scripts/copy_count.py [--copies N]

``chip_smoke.py`` counts a warm epoch's host-to-card copies from the events
whose name holds "HtoD" (``profile_run``); this says which copies that count
sees. Prints one JSON line per case and the card's name and power limit.
"""

import argparse
import json
import subprocess

import numpy as np
import torch
from torch.profiler import ProfilerActivity, profile


def count(fn):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    averages = prof.key_averages()
    return {e.key: e.count for e in averages if "HtoD" in e.key or "Memcpy" in e.key}


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--copies", type=int, default=10)
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit("copy_count.py: no CUDA card available")
    device = torch.device("cuda")
    torch.zeros(1, device=device)
    work = torch.randn(4096, 4096, device=device)
    # 2 KB and 12 KB (O-complex's mask and triples), 32 KB and 192 KB
    # (T-dense's), 2.2 MB (T-dense's permutation)
    for rows in (256, 1_536, 4_096, 24_576, 272_115):
        host = np.arange(rows, dtype=np.int64)
        alone = count(lambda: [torch.tensor(host).to(device)
                               for _ in range(args.copies)])
        first = count(lambda: ([torch.tensor(host).to(device)
                                for _ in range(args.copies)], work @ work))
        print(json.dumps({"bytes": host.nbytes, "copies": args.copies,
                          "alone": alone, "then_a_kernel": first}), flush=True)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip())


if __name__ == "__main__":
    main()
