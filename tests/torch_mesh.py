"""Rank processes of the port's mesh tests (tests/test_torch_parallel.py,
tests/test_torch_mesh_routes.py, tests/test_torch_multiprocess.py).

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


def drift(task, mesh, workdir, timeout: float = 240):
    """How far a "steps" task (``task_steps``; ``config``, ``data`` and
    files relative to the working directory) over the ranks of ``mesh``
    drifts from the same task in this process with one rank and no
    subbatches: both losses and their relative differences. For example
    O-complex's first steps over 1 x 3 ranks on chip_smoke.py phase 26's
    graph::

        python -c "import chip_smoke; from tests import torch_mesh
        chip_smoke.write_dataset('build/drift/data', 26, sizes=chip_smoke.ROUTES_SIZES)
        print(torch_mesh.drift({'name': 'drift', 'kind': 'steps', 'steps': 6,
            'config': 'examples/fb15k-237-complex-1vsall.yaml', 'data': 'build/drift/data',
            'options': {'dataset.name': 'data', 'valid.every': 0}}, (1, 3),
            'build/drift', timeout=3600))"

    A 1 x 1 ``mesh`` with ``train.subbatch_size`` in the options compares
    one process with itself in subbatches."""
    workdir = pathlib.Path(workdir).resolve()
    task = dict(task, data=str(pathlib.Path(task["data"]).resolve()))
    if task.get("config"):
        task["config"] = str(pathlib.Path(task["config"]).resolve())
    options = {**task["options"], "parallel.data": mesh[0], "parallel.model": mesh[1]}
    if mesh[0] * mesh[1] > 1:
        other = launch({"tasks": [dict(task, options=options)]}, mesh[0] * mesh[1],
                       workdir, timeout=timeout)[task["name"]][0]
    else:
        other = task_steps(dict(task, options=options), workdir / "other")
    alone = task_steps(dict(task, options={**options, "parallel.data": 1,
                                           "parallel.model": 1,
                                           "train.subbatch_size": 0}),
                       workdir / "alone")
    return {"alone": alone, "other": other, "relative_difference": {
        k: [abs(a - b) / abs(b) for a, b in zip(other[k], alone[k])]
        for k in ("steps", "epochs")}}


# -- in a rank process -----------------------------------------------------------


def make_config(options, folder, config_file=None):
    """The task's config. ``parallel.partition_edges`` is ``never`` unless
    the options name it: the tests compare the ranks' epochs with one
    process's, which shuffles the whole split."""
    from kge_tpu_torch import Config

    config = Config()
    if config_file is not None:
        config.load(str(config_file))
    config.set("console.quiet", True)
    config.set("job.device", "cpu")
    config.set("random_seed.default", 0)
    config.set("parallel.partition_edges", "never")
    if config_file is None:
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

    config = make_config(task["options"], folder, task.get("config"))
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


class WidestRows:
    """A dispatch mode that records, of every tensor an operation returns
    (the backward pass's among them), the most columns of a 2-D floating
    tensor with ``rows`` rows: the widest score matrix of a batch's rows."""

    def __init__(self, rows):
        from torch.utils._python_dispatch import TorchDispatchMode

        widest = self

        class Mode(TorchDispatchMode):
            def __torch_dispatch__(self, func, types, args=(), kwargs=None):
                out = func(*args, **(kwargs or {}))
                for t in out if isinstance(out, (tuple, list)) else (out,):
                    if (hasattr(t, "dim") and t.dim() == 2 and t.is_floating_point()
                            and t.shape[0] == rows):
                        widest.columns = max(widest.columns, int(t.shape[1]))
                return out

        self.columns = 0
        self.mode = Mode()


def resumed_job(task, folder):
    """The job of ``task["checkpoint"]`` on this mesh, with the task's
    options (and its ``data`` folder, where given) over the checkpoint's,
    ``parallel.partition_edges`` never unless they name it."""
    from kge_tpu_torch import Config
    from kge_tpu_torch.job import Job
    from kge_tpu_torch.utils.io import load_checkpoint

    checkpoint = load_checkpoint(task["checkpoint"])
    new_config = Config.create_from(checkpoint)
    # as make_config: the global shuffle unless the options say otherwise
    options = {"parallel.partition_edges": "never", **task["options"]}
    if "data" in task:
        options["dataset.name"] = task["data"]
    for key, value in options.items():
        new_config.set(key, value, create=True)
    new_config.folder = str(folder)
    new_config.init_folder()
    job = Job.create_from(checkpoint, new_config=new_config)
    job._prepare()
    job._is_prepared = True
    return job


def task_epochs(task, folder):
    """Train ``epochs`` epochs, from the start or from ``checkpoint`` (its
    epoch is ``start``); the losses, then (``valid``) the metrics, and
    (``save``) a checkpoint with this rank's entity rows. ``widths``: also
    the widest 2-D tensor of the rank's batch rows that any operation of
    the epochs returned (``WidestRows``) and the ring's calls."""
    import contextlib

    from kge_tpu_torch.parallel.ring import ring_all_scores

    if task.get("checkpoint"):
        job = resumed_job(task, folder)
    else:
        job = make_job(task, folder)
    start = job.epoch
    out = {"start": start, "losses": []}
    widest = None
    mode = contextlib.nullcontext()
    if task.get("widths"):
        rows = job.batch_size // job.device_ctx.data
        widest = WidestRows(rows)
        mode = widest.mode
        out["rows"] = rows
    ring_calls = ring_all_scores.calls
    with mode:
        for epoch in range(start + 1, start + task.get("epochs", 2) + 1):
            job.epoch = epoch
            out["losses"].append(job.run_epoch()["avg_loss"])
    out["ring_calls"] = ring_all_scores.calls - ring_calls
    if widest is not None:
        out["widest"] = widest.columns
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
    variants = arrays.get("variants") or [None] * len(arrays["batches"])
    for batch, variant in zip(arrays["batches"], variants):
        _, aux = job._train_step({k: torch.tensor(v) for k, v in batch.items()},
                                 job._current_lrs(), variant)
        losses.append(float(job.device_ctx.reduce_data(aux["avg_loss"].clone())))
    if "final_params" not in arrays:
        return {"losses": losses}
    load_jax_params(model, arrays["final_params"])
    return {"losses": losses, "metrics": evaluate(config, dataset, model)}


def task_resume(task, folder):
    """Resume a checkpoint on this mesh and train one more epoch."""
    return task_epochs({"epochs": 1, **task}, folder)


def task_steps(task, folder):
    """How far a mesh drifts from one process, step by step: the first
    ``steps`` batches of epoch 1 through the train step as ``run_epoch``
    takes them, each step's loss over the whole batch, then ``epochs``
    epochs (a fresh epoch order: the steps drew the first epoch's). With
    ``tables`` (a path prefix): every parameter leaf and its optimizer
    state after the steps, to ``<tables>-rank<r>.npz`` (a row shard's rows
    from ``lo``, saved as ``lo``)."""
    import numpy as np
    import torch

    from kge_tpu_torch.parallel import distributed

    job = make_job(task, folder)
    out = {"steps": [], "epochs": []}
    job.epoch = 1
    for _, batch in zip(range(task.get("steps", 0)), job._batches()):
        variant = job._step_variant(batch)
        batch = {k: torch.as_tensor(v) for k, v in batch.items()
                 if k != "true_size" and not isinstance(v, str)}
        _, aux = job._step_with_retries(batch, job._current_lrs(), variant)
        out["steps"].append(float(job.device_ctx.reduce_data(aux["avg_loss"].clone())))
    if task.get("tables"):
        arrays = {"lo": entity_rows(job)[0]}
        for path, param, state in zip(job.optimizer._paths, job.optimizer.params,
                                      job.opt_state["leaves"]):
            name = "/".join(path)
            arrays[name] = param.detach().numpy()
            for key, value in state.items():
                arrays[f"{name}:{key}"] = value.numpy()
        out["tables"] = f"{task['tables']}-rank{distributed.process_index()}.npz"
        np.savez(out["tables"], **arrays)
    for epoch in range(1, task.get("epochs", 0) + 1):
        job.epoch = epoch
        out["epochs"].append(job.run_epoch()["avg_loss"])
    return out


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


def task_ring(task, folder):
    """kge_tpu's ring check (tests/test_parallel.py
    ``test_ring_scoring_engages_and_matches``) on a 1vsAll job under
    ``parallel.ring_scoring`` auto and never, from the same initial
    weights: whether ``_ring_score`` engages, the ring's columns of ids 0..7
    with relation 0 against the unfused schedule's (``never``) in every
    bit, the largest differences of the entity shard's and the relation
    table's gradients of the first batch's loss, and one epoch's loss of
    each."""
    import torch

    from kge_tpu_torch.models.convert import param_leaves
    from kge_tpu_torch.parallel.ring import ring_all_scores

    jobs = {mode: make_job(dict(task, options={**task["options"],
                                              "parallel.ring_scoring": mode}),
                           pathlib.Path(f"{folder}-{mode}"))
            for mode in ("auto", "never")}
    ids = torch.arange(8)
    rel = torch.zeros(8, dtype=torch.long)
    out = {}
    with torch.no_grad():
        calls = ring_all_scores.calls
        ring = jobs["auto"].model._ring_score(ids, rel, 2)
        out["auto_engages"] = ring is not None and ring_all_scores.calls == calls + 1
        out["never_engages"] = jobs["never"].model._ring_score(ids, rel, 2) is not None
        flat = jobs["never"].model.score_sp(ids, rel)
        po_ring = jobs["auto"].model.score_po(rel, ids)
        po_flat = jobs["never"].model.score_po(rel, ids)
    out["shape"] = list(ring.shape)
    out["bits_equal"] = bool(torch.equal(ring.view(torch.int32), flat.view(torch.int32)))
    out["po_bits_equal"] = bool(torch.equal(po_ring.view(torch.int32),
                                            po_flat.view(torch.int32)))
    grads = {}
    for mode, job in jobs.items():
        # each job's own first batch (its epoch order draws from its rng)
        batch = next(iter(job._batches()))
        batch = {k: torch.as_tensor(v) for k, v in batch.items()
                 if k != "true_size" and not isinstance(v, str)}
        local, rows = job._data_shard(batch)
        job._enter_step(rows)
        calls = ring_all_scores.calls
        _, _, got = job._loss_fn(local, None, job.optimizer.params)
        out[f"{mode}_step_ring_calls"] = ring_all_scores.calls - calls
        names = [path for path, _ in param_leaves(job.model)]
        grads[mode] = dict(zip(names, got))
    diffs = {}
    for path, g in grads["auto"].items():
        diffs["/".join(map(str, path))] = float((g - grads["never"][path]).abs().max())
    out["grad_max_abs_diff"] = diffs
    out["grad_max_abs"] = {"/".join(map(str, p)): float(g.abs().max())
                           for p, g in grads["never"].items()}
    for mode, job in jobs.items():
        job.epoch = 1
        out[f"{mode}_loss"] = job.run_epoch()["avg_loss"]
    return out


def task_losses(task, folder):
    """Every loss over the column shards of this rank's model group against
    the loss of the whole rows in this process, on [n, E] scores drawn from
    a seed (the same on every rank): per loss and kind of labels (global
    indexes, or a multi-hot matrix with label smoothing), the largest
    difference of the rows' terms and of the gradient of their sum on the
    rank's columns."""
    import torch

    from kge_tpu_torch.ops import losses
    from kge_tpu_torch.parallel.mesh import DeviceCtx

    config = make_config(task["options"], folder)
    ctx = DeviceCtx.create(config)
    n, E = 12, 40
    lo, hi = ctx.entity_rows(E)
    generator = torch.Generator().manual_seed(3)
    scores = torch.randn(n, E, generator=generator, dtype=torch.float64) * 3
    index = torch.randint(0, E, (n,), generator=generator)
    matrix = (torch.rand(n, E, generator=generator) < 0.15).double()
    matrix[0] = 0.0  # a row without a positive (a padded row's)
    matrix[1, 5] = 1.0
    smoothed = matrix * 0.9 + 1.0 / E
    out = {}
    for name in task["losses"]:
        config.set("train.loss", name)
        config.set("train.loss_arg", float("nan"))
        config.set("train.type", "negative_sampling" if name == "margin_ranking"
                   else "KvsAll")
        loss = losses.KgeLoss.create(config)
        kinds = {"index": (index, index)}
        if name != "margin_ranking":
            kinds["matrix"] = (smoothed, smoothed[:, lo:hi])
        for kind, (whole_labels, local_labels) in kinds.items():
            whole = scores.clone().requires_grad_()
            want = loss.rows(whole, whole_labels)
            want.sum().backward()
            local = scores[:, lo:hi].clone().requires_grad_()
            got = loss.rows(local, local_labels, shard=(lo, hi, ctx))
            got.sum().backward()
            out[f"{name}/{kind}"] = {
                "rows": float((got - want).abs().max()),
                "grad": float((local.grad - whole.grad[:, lo:hi]).abs().max()),
                "scale": float(want.abs().max()),
            }
    return out


def task_init_rows(task, folder):
    """This rank's initial entity rows, to ``<rows>-rank<r>.npz`` with the
    first one's id (``lo``)."""
    import numpy as np

    from kge_tpu_torch.parallel import distributed

    job = make_job(task, folder)
    embedder = job.model.get_s_embedder()
    path = f"{task['rows']}-rank{distributed.process_index()}.npz"
    np.savez(path, lo=(embedder.row_range or (0, 0))[0],
             rows=embedder.embeddings.detach().numpy())
    return {"rows": path}


def _job_from(task, folder, params):
    """A job of ``task`` whose model holds kge_tpu's weights ``params``."""
    from kge_tpu_torch import Dataset
    from kge_tpu_torch.models import KgeModel, load_jax_params

    config = make_config(task["options"], folder)
    dataset = Dataset.create(config, folder=task["data"])
    model = KgeModel.create(config, dataset, init_for_load_only=True)
    load_jax_params(model, params)
    return make_job(task, folder, model=model)


def task_partitioned(task, folder):
    """Partitioned scanned epochs (``parallel.partition_edges``) from
    kge_tpu's initial weights, handed kge_tpu's shard permutations of each
    epoch (``task["arrays"]``, a pickle), with every row of the host's
    split outside this rank's shard poisoned (ids no table holds): the
    epochs' losses, per-batch costs, the shape of the triples on the
    card, and the entity table (to ``<folder>-rank<r>.npz``)."""
    import pickle

    import numpy as np

    from kge_tpu_torch.job.train import partition_layout
    from kge_tpu_torch.parallel import distributed

    with open(task["arrays"], "rb") as f:
        arrays = pickle.load(f)
    job = _job_from(task, folder, arrays["params"])
    ctx = job.device_ctx
    layout = partition_layout(job.num_examples, ctx.data, job.batch_size)
    start = ctx.data_index * layout.base
    owned = np.zeros(job.num_examples, dtype=bool)
    owned[start:start + int(layout.sizes[ctx.data_index])] = True
    triples = job.triples.copy()
    triples[~owned] = 2 ** 31 - 7
    job.triples = triples
    perms = list(arrays["perms"])
    job._draw_scan_permutation = lambda size: perms.pop(0)
    costs = []
    finalize = job._finalize_epoch_scanned

    def recording(fetched, meta):
        costs.append(fetched[0].tolist())
        return finalize(fetched, meta)

    job._finalize_epoch_scanned = recording
    entries = []
    for epoch in range(1, len(arrays["perms"]) + 1):
        job.epoch = epoch
        entries.append(job.run_epoch())
    tables = f"{folder}-rank{distributed.process_index()}.npz"
    np.savez(tables, entity=job.model.get_s_embedder().embeddings.detach().numpy())
    return {"partition_edges": job._partition_edges,
            "scanned": [e.get("scanned") for e in entries],
            "losses": [e["avg_loss"] for e in entries], "costs": costs,
            "device_triples_shape": list(job._device_epoch_triples.shape),
            "tables": str(pathlib.Path(tables).resolve())}


def _oom_once(fn, where):
    """``fn`` raising the card's out-of-memory error at its first call when
    this rank is among ``where``."""
    import torch

    from kge_tpu_torch.parallel import distributed

    state = {"raised": distributed.process_index() not in where}

    def wrapped(*args, **kwargs):
        if not state["raised"]:
            state["raised"] = True
            raise torch.cuda.OutOfMemoryError(
                "CUDA out of memory. Tried to allocate 2.00 GiB")
        return fn(*args, **kwargs)

    return wrapped


def task_auto_tune(task, folder):
    """``train.subbatch_auto_tune`` over the ranks (ROADMAP A.12), with an
    out-of-memory error injected by patching the job, in this order:
    "both": on every rank at the first step, before the optimizer writes;
    then the epoch of a job started at the halved size, from the same seed
    (tables to ``<folder>-<case>-rank<r>.npz``); "after_write": on rank 1
    alone, in its optimizer's update; "one_rank": on rank 1 alone, before
    the optimizer writes, while rank 0 waits in the step's gradient sum
    (the process group is torn down: it comes last). Per case the error
    each rank ended with, its seconds, the logged notes and the
    ``train.subbatch_size`` left for a resume."""
    import time

    import numpy as np
    import torch

    from kge_tpu_torch.parallel import distributed

    rank = distributed.process_index()
    out = {}

    def run(case, options, patch=None):
        job = make_job(dict(task, options={**task["options"], **options}),
                       pathlib.Path(f"{folder}-{case}"))
        notes = []
        log = job.config.log
        job.config.log = lambda msg, *a, **k: (notes.append(msg), log(msg, *a, **k))
        if patch:
            patch(job)
        result = {"error": None, "notes": notes}
        start = time.time()
        try:
            job.epoch = 1
            result["loss"] = job.run_epoch()["avg_loss"]
        except Exception as e:
            result["error"] = f"{type(e).__name__}: {e}"
            result["out_of_memory"] = isinstance(e, torch.cuda.OutOfMemoryError)
        result["seconds"] = time.time() - start
        result["subbatch_size"] = job.config.get("train.subbatch_size")
        result["partition_edges"] = job._partition_edges
        tables = f"{folder}-{case}-rank{rank}.npz"
        np.savez(tables, **{str(i): p.detach().numpy()
                            for i, p in enumerate(job.optimizer.params)})
        result["tables"] = str(pathlib.Path(tables).resolve())
        return result

    tuned = {"train.subbatch_auto_tune": True}
    out["both"] = run("both", tuned, lambda job: setattr(
        job, "_loss_for_batch", _oom_once(job._loss_for_batch, (0, 1))))
    out["halved"] = run("halved", {"train.subbatch_size": task["halved"]})
    out["after_write"] = run("after_write", tuned, lambda job: setattr(
        job.optimizer, "update", _oom_once(job.optimizer.update, (1,))))
    out["one_rank"] = run("one_rank", tuned, lambda job: setattr(
        job, "_loss_for_batch", _oom_once(job._loss_for_batch, (1,))))
    return out


TASKS = {"epochs": task_epochs, "lockstep": task_lockstep, "init_rows": task_init_rows,
         "parity": task_parity, "resume": task_resume, "steps": task_steps,
         "collectives": task_collectives, "ring": task_ring,
         "losses": task_losses, "partitioned": task_partitioned,
         "auto_tune": task_auto_tune}


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
