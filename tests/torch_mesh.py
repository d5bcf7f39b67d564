"""Rank processes of the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_multiprocess.py).

``launch`` starts one process per rank of ``python tests/torch_mesh.py
<spec.json>``, brought up by ``KGE_COORDINATOR_ADDRESS`` /
``KGE_NUM_PROCESSES`` / ``KGE_PROCESS_ID`` on a free port, as the port's
users launch ranks, and over gloo on the CPU. Every rank runs the spec's
tasks in order and prints one ``RESULT <json>`` line per task; the tests
compare the results with the port alone and with kge_tpu. The rank
processes import neither jax nor kge_tpu.
"""

import json
import os
import pathlib
import socket
import subprocess
import sys

TESTS_DIR = pathlib.Path(__file__).resolve().parent
REPO = TESTS_DIR.parent


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(spec, ranks: int, workdir, timeout: float = 240, env_extra=None,
           check=True):
    """Run ``spec`` (a dict with "tasks") on ``ranks`` rank processes;
    returns {task name: [result of rank 0, rank 1, ...]}, or with
    ``check=False`` the processes' (return codes, outputs)."""
    workdir = pathlib.Path(workdir)
    workdir.mkdir(parents=True, exist_ok=True)
    spec_file = workdir / f"spec-{os.getpid()}-{free_port()}.json"
    spec_file.write_text(json.dumps(spec))
    port = free_port()
    procs = []
    for rank in range(ranks):
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        # one thread a rank: the ranks share the host's cores
        env.update(PYTHONPATH=str(REPO), KGE_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                   KGE_NUM_PROCESSES=str(ranks), KGE_PROCESS_ID=str(rank),
                   KGE_DISTRIBUTED_TIMEOUT="60", OMP_NUM_THREADS="1")
        env.update(env_extra or {})
        procs.append(subprocess.Popen(
            [sys.executable, str(TESTS_DIR / "torch_mesh.py"), str(spec_file)],
            cwd=str(workdir), env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
    outs = []
    try:
        for proc in procs:
            outs.append(proc.communicate(timeout=timeout)[0])
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.communicate()
    codes = [proc.returncode for proc in procs]
    if not check:
        return codes, outs
    for code, out in zip(codes, outs):
        assert code == 0, out[-4000:]
    results = {}
    for rank, out in enumerate(outs):
        for line in out.splitlines():
            if line.startswith("RESULT "):
                entry = json.loads(line[len("RESULT "):])
                results.setdefault(entry.pop("name"), {})[rank] = entry
    return {name: [by_rank[r] for r in range(ranks)]
            for name, by_rank in results.items()}


# -- in a rank process -----------------------------------------------------------


def make_config(options, folder):
    from kge_tpu_torch import Config

    config = Config()
    config.set("console.quiet", True)
    config.set("job.device", "cpu")
    config.set("random_seed.default", 0)
    config.load_options({"model": options.get("model", "complex")})
    for key, value in options.items():
        if key != "model":
            config.set(key, value, create=True)
    config.folder = str(folder)
    config.init_folder()
    return config


def make_job(task, folder, model=None):
    from kge_tpu_torch import Dataset
    from kge_tpu_torch.job import TrainingJob
    from kge_tpu_torch.parallel import distributed

    config = make_config(task["options"], folder)
    distributed.barrier("folder")
    dataset = Dataset.create(config, folder=task["data"])
    job = TrainingJob.create(config, dataset, model=model)
    job._prepare()
    job._is_prepared = True
    return job


def evaluate(config, dataset, model):
    """Filtered entity-ranking metrics of ``model`` on the valid split."""
    import torch

    from kge_tpu_torch.job import EvaluationJob

    eval_config = config.clone()
    eval_config.set("job.type", "eval")
    eval_config.set("eval.split", "valid")
    job = EvaluationJob.create(eval_config, dataset, model=model)
    job._prepare()
    job._is_prepared = True
    model.eval()
    with torch.no_grad():
        entry = job._evaluate()
    model.train()
    return {k: v for k, v in entry.items()
            if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))}


def entity_rows(job):
    """This rank's entity rows: (lo, table rows as lists)."""
    embedder = job.model.get_s_embedder()
    lo = embedder.row_range[0] if embedder.row_range else 0
    return lo, embedder.embeddings.detach().tolist()


def task_epochs(task, folder):
    """Train ``epochs`` epochs; the losses, then (``valid``) the metrics,
    and (``save``) a checkpoint with this rank's entity rows."""
    job = make_job(task, folder)
    out = {"losses": []}
    for epoch in range(1, task.get("epochs", 2) + 1):
        job.epoch = epoch
        out["losses"].append(job.run_epoch()["avg_loss"])
    if task.get("valid"):
        out["metrics"] = evaluate(job.config, job.dataset, job.model)
    if task.get("save"):
        job._save(task["save"])
        out["lo"], out["rows"] = entity_rows(job)
    return out


def task_lockstep(task, folder):
    """The initial entity rows and the whole first batch's negatives as
    this rank draws them before it takes its rows."""
    import torch

    job = make_job(task, folder)
    batch = next(iter(job._batches()))
    batch = {k: torch.as_tensor(v) for k, v in batch.items()
             if k != "true_size" and not isinstance(v, str)}
    batch = job._complete_batch(batch)
    lo, rows = entity_rows(job)
    return {"lo": lo, "rows": rows,
            "negatives": {k: v.tolist() for k, v in batch.items()
                          if k.startswith("neg_")}}


def task_parity(task, folder):
    """kge_tpu's initial weights and batches with injected negatives
    (``task["arrays"]``, a pickle) through the raw train step; the losses,
    then the metrics of kge_tpu's final weights."""
    import pickle

    import torch

    from kge_tpu_torch import Dataset
    from kge_tpu_torch.models import KgeModel, load_jax_params

    with open(task["arrays"], "rb") as f:
        arrays = pickle.load(f)
    config = make_config(task["options"], folder)
    dataset = Dataset.create(config, folder=task["data"])
    model = KgeModel.create(config, dataset, init_for_load_only=True)
    load_jax_params(model, arrays["params"])
    job = make_job(task, folder, model=model)
    losses = []
    for batch in arrays["batches"]:
        _, aux = job._train_step({k: torch.tensor(v) for k, v in batch.items()},
                                 job._current_lrs())
        losses.append(float(job.device_ctx.reduce_data(aux["avg_loss"].clone())))
    load_jax_params(model, arrays["final_params"])
    return {"losses": losses, "metrics": evaluate(config, dataset, model)}


def task_resume(task, folder):
    """Resume a checkpoint on this mesh and train one more epoch."""
    from kge_tpu_torch import Config
    from kge_tpu_torch.job import Job
    from kge_tpu_torch.utils.io import load_checkpoint

    checkpoint = load_checkpoint(task["checkpoint"])
    new_config = Config.create_from(checkpoint)
    for key, value in task["options"].items():
        new_config.set(key, value, create=True)
    new_config.folder = str(folder)
    new_config.init_folder()
    job = Job.create_from(checkpoint, new_config=new_config)
    start = job.epoch
    job.epoch = start + 1
    return {"start": start, "losses": [job.run_epoch()["avg_loss"]]}


def task_collectives(task, folder):
    """``fetch`` of a piece that names its rank, and the mesh's
    ``gather_data`` of a scalar that does."""
    import torch

    from kge_tpu_torch.parallel import distributed
    from kge_tpu_torch.parallel.mesh import DeviceCtx

    ctx = DeviceCtx.create(make_config(task["options"], folder))
    rank = distributed.process_index()
    piece = torch.tensor([[rank, -0.0], [0.5, -rank]])
    return {"fetched": distributed.fetch(piece).tolist(),
            "gathered": ctx.gather_data(torch.tensor(10 * rank)).tolist()}


TASKS = {"epochs": task_epochs, "lockstep": task_lockstep,
         "parity": task_parity, "resume": task_resume,
         "collectives": task_collectives}


def main(spec_file):
    from kge_tpu_torch.parallel import distributed

    spec = json.loads(pathlib.Path(spec_file).read_text())
    assert distributed.maybe_initialize(None)
    rank = distributed.process_index()
    for i, task in enumerate(spec["tasks"]):
        folder = pathlib.Path(f"run-{i}-{task['name']}")
        if task.get("raises") == rank:
            raise RuntimeError(f"rank {rank} raises as the test asks")
        result = TASKS[task["kind"]](task, folder)
        print("RESULT " + json.dumps({"name": task["name"], **result}), flush=True)
    distributed.shutdown()


if __name__ == "__main__":
    sys.path.insert(0, str(REPO))
    main(sys.argv[1])
