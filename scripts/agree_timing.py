"""Time the ranks' agreement on a step's outcome (``train.subbatch_auto_tune``
under a mesh, ROADMAP A.12) on one host.

    python scripts/agree_timing.py [--ranks N] [--calls N] [--device cpu|cuda:0]

Starts N rank processes brought up as the package brings them up
(``KGE_COORDINATOR_ADDRESS`` / ``KGE_NUM_PROCESSES`` / ``KGE_PROCESS_ID``,
``parallel/distributed.py`` ``maybe_initialize``; with ``--device cuda:0``
every rank holds a context on that card, as the phases of ``chip_smoke.py``
do). Each rank times ``distributed.agree("ok")`` whole, then the same four
store operations one by one (post, wait, read, removal of the previous
post), then one ``all_reduce`` of a scalar of its device over the world, each
``--calls`` times after one untimed call. Prints one JSON line per rank
and, last, one line with the ranks' medians in milliseconds.
"""

import argparse
import datetime
import json
import os
import socket
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def rank_main(calls: int, device: str):
    import torch

    from kge_tpu_torch import Config
    from kge_tpu_torch.parallel import distributed

    config = Config()
    config.set("job.device", device)
    assert distributed.maybe_initialize(config)
    rank, world = distributed.process_index(), distributed.world_size()
    store = distributed._store

    def timed(fn):
        fn()
        out = []
        for _ in range(calls):
            start = time.perf_counter()
            fn()
            out.append(time.perf_counter() - start)
        return out

    result = {"rank": rank, "agree": timed(lambda: distributed.agree("ok"))}
    ops = {"set": [], "wait": [], "multi_get": [], "delete_key": []}
    state = {"n": 0}

    def by_op():
        state["n"] += 1
        keys = [f"timing/{state['n']}/{r}" for r in range(world)]
        for name, fn in (
                ("set", lambda: store.set(keys[rank], "ok")),
                ("wait", lambda: store.wait(keys, datetime.timedelta(seconds=60))),
                ("multi_get", lambda: store.multi_get(keys)),
                ("delete_key", lambda: state["n"] > 1 and store.delete_key(
                    f"timing/{state['n'] - 1}/{rank}"))):
            start = time.perf_counter()
            fn()
            ops[name].append(time.perf_counter() - start)

    for _ in range(calls + 1):
        by_op()
    for name in ops:
        result[name] = ops[name][1:]
    scalar = torch.zeros((), device=device)
    result["all_reduce"] = timed(lambda: (distributed.all_reduce(scalar),
                                          scalar.item()))
    print("TIMES " + json.dumps(result), flush=True)
    distributed.barrier("end")
    distributed.shutdown()


def main():
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--ranks", type=int, default=2)
    parser.add_argument("--calls", type=int, default=200)
    parser.add_argument("--device", default="cpu")
    parser.add_argument("--rank", type=int, default=None, help=argparse.SUPPRESS)
    args = parser.parse_args()
    if args.rank is not None:
        rank_main(args.calls, args.device)
        return
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    procs = []
    for rank in range(args.ranks):
        env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="1",
                   KGE_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   KGE_NUM_PROCESSES=str(args.ranks), KGE_PROCESS_ID=str(rank),
                   KGE_DISTRIBUTED_TIMEOUT="120")
        procs.append(subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), "--rank", str(rank),
             "--calls", str(args.calls), "--device", args.device],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    results = []
    try:
        for proc in procs:
            out = proc.communicate(timeout=600)[0]
            if proc.returncode != 0:
                sys.exit(f"a rank failed:\n{out[-3000:]}")
            results += [json.loads(line[len("TIMES "):]) for line in out.splitlines()
                        if line.startswith("TIMES ")]
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
    medians = {}
    for name in ("agree", "set", "wait", "multi_get", "delete_key", "all_reduce"):
        medians[name] = [1e3 * statistics.median(r[name]) for r in results]
        print(json.dumps({"op": name, "median_ms_by_rank": medians[name]}))
    print(json.dumps({"ranks": args.ranks, "device": args.device, "calls": args.calls,
                      "median_ms": {k: statistics.median(v) for k, v in medians.items()}}))


if __name__ == "__main__":
    main()
