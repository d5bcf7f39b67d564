"""Settings that kge_tpu honours and the port does not yet: the port refuses
them instead of ignoring them (ROADMAP C.1 and C.2), on the commands that
found the faults (examples/toy-complex-train.yaml on dataset_test, on the
CPU):

- ``<embedder>.pretrain.model_filename``: kge_tpu copies the pretrained rows
  into the new tables; the port raises at model creation (ROADMAP A.5);
- ``parallel.param_dtype`` / ``parallel.compute_dtype`` other than float32:
  the port raises (ROADMAP A.4);
- a device mesh larger than one card (``parallel.data`` or
  ``parallel.model`` above 1): the port raises with kge_tpu's message, as
  kge_tpu does on one device.

``parallel.data: -1`` and ``parallel.model: 1`` (the defaults) still train.
"""

import subprocess
import sys

import pytest

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


@pytest.mark.parametrize("embedder", ["entity_embedder", "relation_embedder"])
def test_pretrained_initialization_is_refused(pretrained, embedder):
    cwd, folder = pretrained
    proc = _run([sys.executable, "-m", "kge_tpu_torch", "start", TOY,
                 "--job.device", "cpu", "--valid.every", "0",
                 f"--complex.{embedder}.pretrain.model_filename",
                 str(folder / "checkpoint_best.pt"),
                 "--folder", str(cwd / f"pre_{embedder}")], cwd=cwd, check=False)
    assert proc.returncode != 0
    assert f"complex.{embedder}.pretrain.model_filename" in proc.stderr
    assert "ROADMAP A.5" in proc.stderr
    assert not (cwd / f"pre_{embedder}" / "checkpoint_00001.pt").exists()


@pytest.mark.parametrize("options,message", [
    (["--parallel.compute_dtype", "bfloat16", "--parallel.param_dtype",
      "bfloat16"], "parallel.param_dtype=bfloat16"),
    (["--parallel.compute_dtype", "bfloat16"], "parallel.compute_dtype=bfloat16"),
    (["--parallel.param_dtype", "float16"], "parallel.param_dtype=float16"),
], ids=["both", "compute", "param"])
def test_dtypes_other_than_float32_are_refused(tmp_path, options, message):
    cwd = _toy_cwd(tmp_path)
    proc = _run([sys.executable, "-m", "kge_tpu_torch", "start", TOY,
                 "--job.device", "cpu", *options, "--folder", str(cwd / "x")],
                cwd=cwd, check=False)
    assert proc.returncode != 0
    assert message in proc.stderr and "ROADMAP A.4" in proc.stderr


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
