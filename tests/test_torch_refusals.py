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
- float16 trains on every route (ROADMAP A.11a and A.11b;
  tests/test_torch_float16.py), the fused row update on the row-sparse
  step and the pooled distance kernels among them, which the port refused
  before A.11b; any other dtype (``float64``) is refused;
- a device mesh larger than one card (``parallel.data`` or
  ``parallel.model`` above 1): the port raises with kge_tpu's message, as
  kge_tpu does on one device.

``parallel.data: -1`` and ``parallel.model: 1`` (the defaults) still train.

The command that found ROADMAP C.5, where the port trained alone:
``parallel.distributed.*`` (a coordinator with more than one process, the
``KGE_COORDINATOR_ADDRESS`` / ``KGE_NUM_PROCESSES`` / ``KGE_PROCESS_ID``
environment, or ``parallel.distributed.auto`` under a launcher) now brings
up one rank a process (ROADMAP A.10; tests/test_torch_parallel.py,
tests/test_torch_distributed_auto.py), the data axis with
``train.subbatch_size`` and ConvE's batch statistics included. ``auto``
without a launcher's environment is refused, as kge_tpu's
``jax.distributed.initialize()`` refuses it, and so is a mesh that does not
fit the ranks. One process, or none named, still trains.

The command that found ROADMAP C.7, whose setting the port ignored,
``train.subbatch_auto_tune`` under a mesh of 2 x 1 ranks, was refused until
ROADMAP A.12 ported it: the ranks halve the subbatch and retry together, as
kge_tpu's do (tests/test_torch_auto_tune_mesh.py).
"""

import shutil
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


NEGS = str(EXAMPLES_DIR / "toy-complex-train-negs.yaml")
#: an Adam eps at which float16 tables train at lr 0.2
ADAM_F16_EPS = ("--train.optimizer.default.args.eps", "1e-4")
TRANSE = str(EXAMPLES_DIR / "toy-transe-train.yaml")


@pytest.mark.parametrize("config,options,message", [
    (TOY, ["--parallel.param_dtype", "float64"],
     "parallel.param_dtype=float64: kge_tpu_torch runs float32, bfloat16 and "
     "float16"),
    (NEGS, ["--parallel.param_dtype", "float16", "--train.sparse_embedding_update",
            "always", "--train.optimizer.default.type", "Adam",
            *ADAM_F16_EPS], None),
    (TRANSE, ["--parallel.compute_dtype", "float16", "--transe.l_norm", "1.0",
              "--negative_sampling.implementation", "pool",
              "--negative_sampling.pooled_kernel", "always"], None),
], ids=["param", "rows_adam", "pooled"])
def test_float16_runs_and_other_dtypes_are_refused(tmp_path, config, options,
                                                   message):
    """What stays refused of the dtypes (kge_tpu would run it): float64.
    float16 runs on the routes that ROADMAP A.11b ported: Adam on the
    row-sparse step (the fused row update) ends its epochs with float16
    tables and float16 moments, and pooled TransE-L1 scores (the pooled
    distance kernels' plain version) with a finite loss.

    Adam's command as it was refused, with its default eps 1e-8, is no
    longer refused, and ends as kge_tpu's run of it ends, in ``Cost became
    nan``: at lr 0.2, ``v = 0.001 g^2`` underflows to 0 in float16 for
    |g| below about 7.7e-3, and the step ``m_hat / (0 + 1e-8)`` overflows
    the float16 table (float16 Adam itself, with kge_tpu's kernel's
    semantics as with its dense fallback's). With eps 1e-4 (``ADAM_F16_EPS``)
    both packages train it."""
    cwd = _toy_cwd(tmp_path)
    folder = cwd / "x"

    def start(*argv):
        return _run([sys.executable, "-m", "kge_tpu_torch", "start", config,
                     "--job.device", "cpu", *argv, "--train.max_epochs", "2",
                     "--valid.every", "0", "--folder", str(folder)],
                    cwd=cwd, check=False)

    if "Adam" in options:
        default_eps = [x for x in options if x not in ADAM_F16_EPS]
        proc = start(*default_eps)
        assert proc.returncode != 0 and "ValueError" not in proc.stderr
        assert "FloatingPointError: Cost became nan" in proc.stderr, proc.stderr[-2000:]
        shutil.rmtree(folder)
    proc = start(*options)
    if message is not None:
        assert proc.returncode != 0
        assert f"ValueError: {message}" in proc.stderr, proc.stderr[-2000:]
        return
    assert proc.returncode == 0, proc.stderr[-2000:]
    losses = [e["avg_loss"] for e in _entries(folder, event="epoch_completed")]
    assert len(losses) == 2 and np.isfinite(losses).all()
    saved = load_checkpoint(str(folder / "checkpoint_00002.pt"))
    if "--parallel.param_dtype" in options:
        for leaf in saved["model"][0].values():
            assert leaf_tensor(leaf["embeddings"]).dtype == torch.float16
        for leaf in saved["optimizer_state"]["leaves"]:
            assert {leaf_tensor(v).dtype for v in leaf.values()} == {torch.float16}


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
CONVE = str(EXAMPLES_DIR / "toy-conve-train.yaml")


@pytest.mark.parametrize("config,options,ranks,by,message", [
    (TOY, ["--parallel.data", "1", "--parallel.model", "1"], 2, "config",
     "mesh 1x1 holds 1 of the 2 processes"),
    (TOY, ["--parallel.distributed.auto", "true"], 1, None,
     "parallel.distributed.auto: no launcher environment found"),
    (TOY, ["--parallel.distributed.auto", "true", "--parallel.data", "2"], 2,
     "torchrun", None),
    (TOY, ["--parallel.data", "2", "--parallel.model", "1", "--train.subbatch_size",
           "2"], 2, "environment", None),
    (CONVE, ["--parallel.data", "2"], 2, "environment", None),
], ids=["coordinator", "auto", "auto_torchrun", "environment", "conve_statistics"])
def test_runs_over_several_processes_are_refused(tmp_path, config, options, ranks,
                                                 by, message):
    """Runs over several processes train (tests/test_torch_parallel.py),
    those that ROADMAP A.10c once refused among them: ``auto`` under a
    launcher (torchrun's variables alone), the data axis with
    ``train.subbatch_size`` and with ConvE's batch statistics
    (tests/test_torch_data_axis.py, tests/test_torch_mesh_routes.py); each
    writes its checkpoint. What is refused, on every rank before it trains
    (``message``): ``auto`` without a launcher environment, and a mesh that
    leaves a rank without a place, with kge_tpu's kind of message. The
    ranks come up from the ``parallel.distributed`` keys ("config"), the
    ``KGE_*`` environment or torchrun's variables. ``train.subbatch_auto_tune``
    under a mesh, refused from ROADMAP C.7 until A.12, trains
    (tests/test_torch_auto_tune_mesh.py)."""
    from tests.test_torch_distributed_auto import LAUNCH_VARIABLES
    from tests.torch_mesh import free_port
    from tests.util import make_synthetic_dataset

    cwd = _toy_cwd(tmp_path)
    make_synthetic_dataset(cwd / "data" / "synth")
    port = str(free_port())
    procs = []
    for rank in range(ranks):
        env, argv = _env(), list(options)
        for name in LAUNCH_VARIABLES:
            env.pop(name, None)
        env["KGE_DISTRIBUTED_TIMEOUT"] = "60"
        if by == "config":
            argv += ["--parallel.distributed.coordinator_address", f"127.0.0.1:{port}",
                     "--parallel.distributed.num_processes", str(ranks),
                     "--parallel.distributed.process_id", str(rank)]
        elif by == "environment":
            env.update(KGE_COORDINATOR_ADDRESS=f"127.0.0.1:{port}",
                       KGE_NUM_PROCESSES=str(ranks), KGE_PROCESS_ID=str(rank))
        elif by == "torchrun":
            env.update(MASTER_ADDR="127.0.0.1", MASTER_PORT=port,
                       WORLD_SIZE=str(ranks), RANK=str(rank), LOCAL_RANK=str(rank))
        procs.append(subprocess.Popen(
            [sys.executable, "-m", "kge_tpu_torch", "start", config, "--job.device",
             "cpu", "--train.max_epochs", "1", *argv, "--folder", str(cwd / "x")],
            cwd=str(cwd), env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True))
    for proc in procs:
        _, stderr = proc.communicate(timeout=300)
        if message is None:
            assert proc.returncode == 0, stderr[-2000:]
        else:
            assert proc.returncode != 0
            assert f"ValueError: {message}" in stderr, stderr[-2000:]
            assert "ROADMAP A.10c" not in stderr
    assert (cwd / "x" / "checkpoint_00001.pt").exists() == (message is None)


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
