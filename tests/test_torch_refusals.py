"""The commands that found ROADMAP C.1 and C.2 (examples/toy-complex-train.yaml
on dataset_test, on the CPU), once refused by the port:

- ``<embedder>.pretrain.model_filename``: both packages copy the pretrained
  rows into the new table (ROADMAP A.5, done): the initial checkpoints'
  tables are equal bit for bit;
- ``parallel.param_dtype`` / ``parallel.compute_dtype`` in bfloat16: both
  packages train (ROADMAP A.4, done), with losses within bfloat16
  tolerances and checkpoints of the same dtypes; kge_tpu on
  ``train.epoch_scan: never`` (its scanned KvsAll epoch fails on bfloat16
  tables, ROADMAP C.4);
- any other dtype (``float16``): the port raises (ROADMAP A.11);
- a device mesh larger than one card (``parallel.data`` or
  ``parallel.model`` above 1): the port raises with kge_tpu's message, as
  kge_tpu does on one device.

``parallel.data: -1`` and ``parallel.model: 1`` (the defaults) still train.

The command that found ROADMAP C.5, where the port trained alone:
``parallel.distributed.*`` (a coordinator with more than one process,
``auto``, or the ``KGE_COORDINATOR_ADDRESS`` / ``KGE_NUM_PROCESSES`` /
``KGE_PROCESS_ID`` environment) is refused, naming ROADMAP A.10; one
process, or none named, still trains.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch

from kge_tpu_torch.models.convert import leaf_tensor
from kge_tpu_torch.utils.io import load_checkpoint
from tests.test_torch_cli import EXAMPLES_DIR, _entries, _env, _run, _toy_cwd

TOY = str(EXAMPLES_DIR / "toy-complex-train.yaml")


@pytest.fixture(scope="module")
def pretrained(tmp_path_factory):
    """(working directory, folder F of a one-epoch run with a validation)."""
    cwd = _toy_cwd(tmp_path_factory.mktemp("torch_refusals"))
    folder = cwd / "F"
    _run([sys.executable, "-m", "kge_tpu_torch", "start", TOY, "--job.device",
          "cpu", "--train.max_epochs", "1", "--valid.every", "1", "--folder",
          str(folder)], cwd=cwd)
    assert (folder / "checkpoint_best.pt").exists()
    return cwd, folder


def _table(folder, checkpoint, embedder):
    tree = load_checkpoint(str(folder / checkpoint))["model"][0]
    return leaf_tensor(tree[embedder]["embeddings"])


@pytest.mark.parametrize("embedder", ["entity_embedder", "relation_embedder"])
def test_pretrained_initialization_matches_kge_tpu(pretrained, embedder):
    """The refused command now trains; its initial table equals kge_tpu's
    from the same command bit for bit, and F's rows."""
    cwd, folder = pretrained
    source = folder / "checkpoint_best.pt"
    runs = {}
    for package in ("kge_tpu_torch", "kge_tpu"):
        runs[package] = cwd / f"pre_{embedder}_{package}"
        _run([sys.executable, "-m", package, "start", TOY,
              "--job.device", "cpu", "--valid.every", "0",
              f"--complex.{embedder}.pretrain.model_filename", str(source),
              "--folder", str(runs[package])], cwd=cwd)
    assert (runs["kge_tpu_torch"] / "checkpoint_00010.pt").exists()
    got = _table(runs["kge_tpu_torch"], "checkpoint_00000.pt", embedder)
    want = _table(runs["kge_tpu"], "checkpoint_00000.pt", embedder)
    assert torch.equal(got, want)
    assert torch.equal(got, _table(folder, "checkpoint_best.pt", embedder))


@pytest.mark.parametrize("options", [
    ["--parallel.compute_dtype", "bfloat16", "--parallel.param_dtype",
     "bfloat16"],
    ["--parallel.compute_dtype", "bfloat16"],
], ids=["both", "compute"])
def test_bfloat16_dtypes_train_as_kge_tpu_trains(tmp_path, options):
    """The refused commands now train, two epochs each. kge_tpu resumes the
    port's initial checkpoint (bfloat16 tables cross as ``ml_dtypes``
    arrays) for the same two epochs: the epochs' losses agree within rtol
    2e-2 (bfloat16 scores), and the last checkpoints hold leaves of the
    same dtypes (float32 after the dense step, ROADMAP C.4)."""
    import shutil

    cwd = _toy_cwd(tmp_path)
    port, jax_run = cwd / "port", cwd / "kge_tpu"
    _run([sys.executable, "-m", "kge_tpu_torch", "start", TOY, "--job.device",
          "cpu", *options, "--train.max_epochs", "2", "--valid.every", "0",
          "--folder", str(port)], cwd=cwd)
    jax_run.mkdir()
    for name in ("config.yaml", "checkpoint_00000.pt"):
        shutil.copy(port / name, jax_run / name)
    _run([sys.executable, "-m", "kge_tpu", "resume", str(jax_run),
          "--train.epoch_scan", "never"], cwd=cwd)
    losses = {folder.name: [e["avg_loss"] for e in
                            _entries(folder, event="epoch_completed")]
              for folder in (port, jax_run)}
    assert len(losses["kge_tpu"]) == 2
    np.testing.assert_allclose(losses["port"], losses["kge_tpu"], rtol=2e-2)
    dtypes = {
        folder.name: {key: leaf_tensor(leaf["embeddings"]).dtype
                      for key, leaf in load_checkpoint(str(
                          folder / "checkpoint_00002.pt"))["model"][0].items()}
        for folder in (port, jax_run)}
    assert dtypes["port"] == dtypes["kge_tpu"]


@pytest.mark.parametrize("options,message", [
    (["--parallel.param_dtype", "float16"], "parallel.param_dtype=float16"),
], ids=["param"])
def test_dtypes_other_than_float32_are_refused(tmp_path, options, message):
    """Dtypes other than float32 and bfloat16 (kge_tpu would run them)."""
    cwd = _toy_cwd(tmp_path)
    proc = _run([sys.executable, "-m", "kge_tpu_torch", "start", TOY,
                 "--job.device", "cpu", *options, "--folder", str(cwd / "x")],
                cwd=cwd, check=False)
    assert proc.returncode != 0
    assert message in proc.stderr and "ROADMAP A.11" in proc.stderr


@pytest.mark.parametrize("options,message", [
    (["--parallel.model", "4"], "mesh 1x4 needs 4 devices, have 1"),
    (["--parallel.data", "2"], "mesh 2x1 needs 2 devices, have 1"),
], ids=["model4", "data2"])
def test_meshes_beyond_one_card_are_refused_as_kge_tpu_refuses(
        tmp_path, options, message):
    """Both packages exit non-zero with the same message on one device (the
    virtual CPU devices of the test process are not passed on)."""
    cwd = _toy_cwd(tmp_path)
    env = _env()
    env["XLA_FLAGS"] = " ".join(
        flag for flag in env.get("XLA_FLAGS", "").split()
        if "xla_force_host_platform_device_count" not in flag)
    for package in ("kge_tpu_torch", "kge_tpu"):
        proc = subprocess.run(
            [sys.executable, "-m", package, "start", TOY, "--job.device", "cpu",
             "--train.max_epochs", "1", *options, "--folder", str(cwd / package)],
            cwd=str(cwd), env=env, capture_output=True, text=True, timeout=600)
        assert proc.returncode != 0, package
        assert f"ValueError: {message}" in proc.stderr, (package, proc.stderr[-2000:])


def test_one_card_in_float32_still_trains(tmp_path):
    """The defaults spelled out: ``parallel.data -1``, ``parallel.model 1``,
    float32 parameters and compute."""
    cwd = _toy_cwd(tmp_path)
    folder = cwd / "ok"
    _run([sys.executable, "-m", "kge_tpu_torch", "start", TOY, "--job.device",
          "cpu", "--train.max_epochs", "2", "--valid.every", "0",
          "--parallel.data", "-1", "--parallel.model", "1",
          "--parallel.param_dtype", "float32", "--parallel.compute_dtype",
          "float32", "--folder", str(folder)], cwd=cwd)
    assert [e["epoch"] for e in _entries(folder, event="epoch_completed")] == [1, 2]


_COORDINATOR = ["--parallel.distributed.coordinator_address", "127.0.0.1:9999",
                "--parallel.distributed.process_id", "0"]


@pytest.mark.parametrize("options,environment,message", [
    (_COORDINATOR + ["--parallel.distributed.num_processes", "2"], {},
     "parallel.distributed: 2 processes at 127.0.0.1:9999"),
    (["--parallel.distributed.auto", "true"], {}, "parallel.distributed.auto"),
    ([], {"KGE_COORDINATOR_ADDRESS": "127.0.0.1:9999", "KGE_NUM_PROCESSES": "2",
          "KGE_PROCESS_ID": "0"},
     "KGE_COORDINATOR_ADDRESS / KGE_NUM_PROCESSES: 2 processes at 127.0.0.1:9999"),
], ids=["coordinator", "auto", "environment"])
def test_runs_over_several_processes_are_refused(tmp_path, options, environment,
                                                 message):
    """ROADMAP C.5's command and its two other forms: the port exits
    non-zero naming ROADMAP A.10 before it trains."""
    cwd = _toy_cwd(tmp_path)
    env = {**_env(), **environment}
    proc = subprocess.run(
        [sys.executable, "-m", "kge_tpu_torch", "start", TOY, "--job.device",
         "cpu", "--train.max_epochs", "1", *options, "--folder", str(cwd / "x")],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode != 0
    assert f"ValueError: {message}" in proc.stderr, proc.stderr[-2000:]
    assert "ROADMAP A.10" in proc.stderr
    assert not (cwd / "x" / "checkpoint_00001.pt").exists()


def test_one_process_still_trains(tmp_path):
    """A coordinator of one process, and the environment naming one, run
    alone as before."""
    cwd = _toy_cwd(tmp_path)
    folder = cwd / "one"
    env = {**_env(), "KGE_COORDINATOR_ADDRESS": "127.0.0.1:9999",
           "KGE_NUM_PROCESSES": "1", "KGE_PROCESS_ID": "0"}
    proc = subprocess.run(
        [sys.executable, "-m", "kge_tpu_torch", "start", TOY, "--job.device",
         "cpu", "--train.max_epochs", "1", "--valid.every", "0", *_COORDINATOR,
         "--parallel.distributed.num_processes", "1", "--folder", str(folder)],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr[-2000:]
    assert [e["epoch"] for e in _entries(folder, event="epoch_completed")] == [1]
