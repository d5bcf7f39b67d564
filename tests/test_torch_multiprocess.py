"""The port over several processes through its command line, and sharded
checkpoints across the packages (the counterpart of
tests/test_multiprocess.py).

- ``python -m kge_tpu_torch start`` as 4 rank processes (a 2 x 2 mesh over
  gloo, the ``KGE_*`` environment) trains 2 epochs with a validation each
  and writes sharded checkpoints; ``resume`` goes on to epoch 3 over the
  ranks and in one process from the same shard files, and ``test`` of the
  checkpoint over the ranks equals ``test`` in one process, metric for
  metric. The epochs' losses equal one process's within rtol 1e-4, atol
  1e-5.
- kge_tpu's two-process run on its 2 x 2 mesh (tests/test_multiprocess.py's
  worker, with negative sampling and with 1vsAll) writes a sharded
  checkpoint; the port loads it, its tables equal to kge_tpu's reassembly,
  and resumes it in one process and over 4 ranks, whose epochs' losses
  agree within rtol 1e-4.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest
import yaml

from tests import torch_mesh
from tests.util import make_synthetic_dataset

CONFIG = {
    "job": {"device": "cpu"},
    "dataset": {"name": "synth_mp"},
    "model": "complex",
    "complex": {"entity_embedder": {"dim": 16}, "relation_embedder": {"dim": 16}},
    "train": {"type": "negative_sampling", "batch_size": 64, "max_epochs": 2,
              "optimizer": {"default": {"type": "Adagrad", "args": {"lr": 0.1}}},
              "checkpoint": {"every": 1}},
    "negative_sampling": {"shared": True},
    "valid": {"every": 1},
    "random_seed": {"default": 11},
    "console": {"quiet": True},
    # the ranks compute one process's epochs: the global shuffle, which
    # edge partitioning (on by default over ranks) replaces
    "parallel": {"partition_edges": "never"},
}


def _cli(argv, cwd, ranks):
    """``python -m kge_tpu_torch <argv>`` as ``ranks`` processes (one alone
    without the ``KGE_*`` environment); every process must exit 0."""
    port = torch_mesh.free_port()
    procs = []
    for rank in range(ranks):
        env = {k: v for k, v in os.environ.items()
               if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
        env.update(PYTHONPATH=str(torch_mesh.REPO), OMP_NUM_THREADS="1",
                   KGE_DISTRIBUTED_TIMEOUT="60")
        if ranks > 1:
            env.update(KGE_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       KGE_NUM_PROCESSES=str(ranks), KGE_PROCESS_ID=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kge_tpu_torch", *argv], cwd=str(cwd), env=env,
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    for proc in procs:
        out = proc.communicate(timeout=240)[0]
        assert proc.returncode == 0, out[-4000:]


def _entries(folder, event):
    with open(os.path.join(folder, "trace.yaml")) as f:
        return [e for e in map(yaml.safe_load, f) if e.get("event") == event]


def _losses(folder):
    return {e["epoch"]: e["avg_loss"] for e in _entries(folder, "epoch_completed")}


def _metrics(folder):
    entry = [e for e in _entries(folder, "eval_completed")
             if e.get("scope") == "epoch"][-1]
    return {k: v for k, v in entry.items()
            if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))}


@pytest.mark.timeout(600)
def test_cli_over_four_ranks_computes_one_process(tmp_path):
    make_synthetic_dataset(tmp_path / "data" / "synth_mp", seed=4)
    config = tmp_path / "config.yaml"
    config.write_text(yaml.safe_dump(CONFIG))
    mesh = ["--parallel.data", "2", "--parallel.model", "2"]
    alone = ["--parallel.data", "1", "--parallel.model", "1"]
    _cli(["start", str(config), "--folder", "alone", *alone], tmp_path, 1)
    _cli(["start", str(config), "--folder", "ranks", *mesh], tmp_path, 4)
    ranks, one = tmp_path / "ranks", tmp_path / "alone"
    for epoch in (1, 2):
        np.testing.assert_allclose(_losses(ranks)[epoch], _losses(one)[epoch],
                                   rtol=1e-4, atol=1e-5)
    assert len(_entries(ranks, "eval_completed")) == 2
    assert all((ranks / f"checkpoint_00002.pt.shard{r:05d}").exists()
               for r in range(4))
    shutil.copytree(ranks, tmp_path / "resumed_alone")
    _cli(["resume", "ranks", "--train.max_epochs", "3"], tmp_path, 4)
    _cli(["resume", "resumed_alone", "--train.max_epochs", "3", *alone], tmp_path, 1)
    np.testing.assert_allclose(_losses(ranks)[3], _losses(tmp_path / "resumed_alone")[3],
                               rtol=1e-4, atol=1e-5)
    _cli(["test", "ranks"], tmp_path, 4)
    over_ranks = _metrics(ranks)
    _cli(["test", "ranks", *alone], tmp_path, 1)
    assert _metrics(ranks) == over_ranks and len(over_ranks) > 10


@pytest.mark.timeout(600)
@pytest.mark.parametrize("train_type", ["negative_sampling", "1vsAll"])
def test_kge_tpu_sharded_checkpoint_resumes_in_the_port(tmp_path, train_type):
    """kge_tpu's two processes on its 2 x 2 mesh write checkpoint_00002.pt
    and two shard files (tests/test_multiprocess.py ``WORKER_PART``, its
    training type replaced by ``train_type``); the port reassembles the
    tables as kge_tpu does and resumes the checkpoint in one process and
    over 4 ranks, negative sampling with kge_tpu's ``auto`` (``pool``, which
    the model axis now runs)."""
    from kge_tpu.utils.io import load_checkpoint as kge_tpu_load
    from kge_tpu_torch.models.convert import leaf_tensor
    from kge_tpu_torch.utils.io import load_checkpoint
    from tests.test_multiprocess import REPO, WORKER_PART

    data = make_synthetic_dataset(tmp_path / "synth_mp", seed=4)
    out = tmp_path / "exp_kge_tpu"
    script = tmp_path / "worker_part.py"
    worker = WORKER_PART.format(repo=str(REPO))
    assert 'config.set("train.type", "negative_sampling")' in worker
    script.write_text(worker.replace('config.set("train.type", "negative_sampling")',
                                     f'config.set("train.type", "{train_type}")'))
    port = str(torch_mesh.free_port())
    env = {k: v for k, v in os.environ.items() if k not in ("JAX_PLATFORMS", "XLA_FLAGS")}
    procs = [subprocess.Popen([sys.executable, str(script), str(pid), "2", port,
                               str(data), str(out)], env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for pid in (0, 1)]
    for proc in procs:
        output = proc.communicate(timeout=300)[0]
        assert proc.returncode == 0, output[-3000:]
    checkpoint_file = out / "checkpoint_00002.pt"
    assert (out / "checkpoint_00002.pt.shard00001").exists()

    theirs = kge_tpu_load(str(checkpoint_file))
    ours = load_checkpoint(str(checkpoint_file))
    for embedder in ("entity_embedder", "relation_embedder"):
        assert np.array_equal(
            leaf_tensor(ours["model"][0][embedder]["embeddings"]).numpy(),
            np.asarray(theirs["model"][0][embedder]["embeddings"]))
    assert np.array_equal(
        np.asarray(ours["optimizer_state"]["leaves"][0]["sum"]),
        np.asarray(theirs["optimizer_state"]["leaves"][0]["sum"]))

    options = {"job.device": "cpu", "train.max_epochs": 3,
               "parallel.distributed.coordinator_address": "",
               "parallel.distributed.num_processes": -1,
               "parallel.distributed.process_id": -1,
               "dataset.name": str(data), "console.quiet": True}
    task = {"name": "resume", "kind": "resume", "checkpoint": str(checkpoint_file)}
    alone = torch_mesh.TASKS["resume"](
        {**task, "options": {**options, "parallel.data": 1, "parallel.model": 1}},
        tmp_path / "alone")
    ranks = torch_mesh.launch(
        {"tasks": [{**task, "options": {**options, "parallel.data": 2,
                                        "parallel.model": 2}}]}, 4, tmp_path / "ranks")
    assert alone["start"] == 2
    for got in ranks["resume"]:
        assert got["start"] == 2
        np.testing.assert_allclose(got["losses"], alone["losses"], rtol=1e-4)
