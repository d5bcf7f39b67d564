"""The port's command line against kge_tpu's. On a folder that kge_tpu
trained, ``python -m kge_tpu_torch test <folder> --job.device cpu`` reports
kge_tpu's own test metrics and loads neither jax nor any module of kge_tpu;
with no card, ``job.device: auto`` fails loudly instead of running on the
host. ``start`` and ``resume`` train on the CPU, and checkpoints cross both
ways: kge_tpu loads and resumes what the port wrote, the port resumes what
kge_tpu wrote, and ``valid`` of either package reports the same metrics on
either folder, for the distance models too; their training runs validate
on schedule and keep every checkpoint."""

import json
import os
import pathlib
import re
import shutil
import subprocess
import sys

import pytest
import torch
import yaml

from tests.util import DATASET_DIR, TESTS_DIR

REPO_ROOT = TESTS_DIR.parent
PACKAGE_DIR = REPO_ROOT / "kge_tpu_torch"
EXAMPLES_DIR = REPO_ROOT / "examples"

# runs the CLI as `python -m kge_tpu_torch` does, then reports which
# modules the process holds
_RUN_AND_REPORT = """
import json, runpy, sys
sys.argv = ["kge_tpu_torch"] + sys.argv[1:]
runpy.run_module("kge_tpu_torch", run_name="__main__", alter_sys=True)
print("MODULES=" + json.dumps(sorted(
    m for m in sys.modules if m == "jax" or m.startswith(("jax.", "kge_tpu."))
    or m == "kge_tpu"
)))
"""


def _env():
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["PYTHONPATH"] = str(REPO_ROOT) + os.pathsep + env.get("PYTHONPATH", "")
    return env


def _run(argv, cwd, check=True):
    proc = subprocess.run(
        argv, cwd=str(cwd), env=_env(), capture_output=True, text=True,
        timeout=600,
    )
    if check and proc.returncode != 0:
        raise AssertionError(f"{argv} failed:\n{proc.stdout}\n{proc.stderr}")
    return proc


def _eval_entries(folder):
    entries = []
    with open(folder / "trace.yaml") as f:
        for line in f:
            entry = yaml.safe_load(line)
            if entry.get("event") == "eval_completed" and entry.get("split") == "test":
                entries.append(entry)
    return entries


@pytest.fixture(scope="module", params=["complex", "reciprocal_complex"])
def trained(request, tmp_path_factory):
    """A folder in which kge_tpu trained the toy config for one epoch and
    then ran its own `test`."""
    tmp = tmp_path_factory.mktemp("torch_cli")
    options = {
        "job": {"device": "cpu"},
        "model": "complex",
        "dataset": {"name": str(DATASET_DIR)},
        "train": {"type": "KvsAll", "max_epochs": 1, "batch_size": 4},
        "lookup_embedder": {"dim": 8},
        "valid": {"every": 0},
        "console": {"quiet": True},
        "random_seed": {"default": 2},
        "entity_ranking": {"metrics_per": {"head_and_tail": True}},
    }
    if request.param == "reciprocal_complex":
        options["model"] = "reciprocal_relations_model"
        options["reciprocal_relations_model"] = {"base_model": {"type": "complex"}}
    conf = tmp / "toy.yaml"
    with open(conf, "w") as f:
        yaml.safe_dump(options, f)
    folder = tmp / "exp"
    _run([sys.executable, "-m", "kge_tpu", "start", str(conf), "--folder",
          str(folder)], cwd=tmp)
    _run([sys.executable, "-m", "kge_tpu", "test", str(folder)], cwd=tmp)
    (expected,) = _eval_entries(folder)
    return tmp, folder, expected


def test_port_test_verb_reports_kge_tpu_metrics(trained):
    tmp, folder, expected = trained
    proc = _run([sys.executable, "-c", _RUN_AND_REPORT, "test", str(folder),
                 "--job.device", "cpu"], cwd=tmp)
    entries = _eval_entries(folder)
    assert len(entries) == 2
    got = entries[-1]
    keys = [k for k in expected
            if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))]
    assert any(k.endswith("_head") for k in keys)
    for key in keys:
        assert got[key] == expected[key] or (
            got[key] != got[key] and expected[key] != expected[key]
        ), key
    assert set(keys) == {
        k for k in got
        if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))
    }
    modules = json.loads(
        re.search(r"^MODULES=(.*)$", proc.stdout, re.M).group(1)
    )
    assert modules == []


def test_auto_device_without_card_fails(trained):
    tmp, folder, _ = trained
    proc = _run([sys.executable, "-m", "kge_tpu_torch", "valid", str(folder),
                 "--job.device", "auto"], cwd=tmp, check=False)
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr
    else:
        assert proc.returncode != 0
        assert "needs a CUDA card" in proc.stderr


@pytest.mark.parametrize("verb", ["dump", "package"])
def test_verbs_not_ported_exit_nonzero(tmp_path, verb):
    """``dump`` and ``package`` are ported (tests/test_torch_dump.py): on a
    file that is not there they exit non-zero for that reason, as kge_tpu's
    do, and no longer as verbs not ported."""
    argv = {"dump": ["dump", "config", "x.yaml"], "package": ["package", "x.pt"]}
    for package in ("kge_tpu_torch", "kge_tpu"):
        proc = _run([sys.executable, "-m", package, *argv[verb]],
                    cwd=tmp_path, check=False)
        assert proc.returncode != 0
        assert "not ported yet" not in proc.stderr
        assert "FileNotFoundError" in proc.stderr, (package, proc.stderr[-2000:])


# -- training through the command line, and checkpoints both ways ---------------

_TRAIN_OPTIONS = {
    "job": {"device": "cpu"},
    "model": "complex",
    "dataset": {"name": str(DATASET_DIR)},
    "train": {"type": "negative_sampling", "max_epochs": 2, "batch_size": 6,
              "optimizer": {"default": {"args": {"lr": 0.2}}},
              "checkpoint": {"every": 1}},
    "negative_sampling": {"shared": True, "num_samples": {"s": 4}},
    "lookup_embedder": {"dim": 8},
    "valid": {"every": 2, "metric": "mean_reciprocal_rank_filtered"},
    "entity_ranking": {"hits_at_k_s": [1, 3]},
    "console": {"quiet": True},
    "random_seed": {"default": 3},
}


def _entries(folder, **match):
    out = []
    with open(folder / "trace.yaml") as f:
        for line in f:
            entry = yaml.safe_load(line)
            if all(entry.get(k) == v for k, v in match.items()):
                out.append(entry)
    return out


def _metrics(entry):
    return {k: v for k, v in entry.items()
            if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))}


@pytest.fixture(scope="module")
def started(tmp_path_factory):
    """(tmp, folder the port trained for 2 epochs, folder kge_tpu trained for
    2 epochs), both from the same config file."""
    tmp = tmp_path_factory.mktemp("torch_cli_train")
    conf = tmp / "toy.yaml"
    with open(conf, "w") as f:
        yaml.safe_dump(_TRAIN_OPTIONS, f)
    port = tmp / "port"
    _run([sys.executable, "-m", "kge_tpu_torch", "start", str(conf),
          "--folder", str(port)], cwd=tmp)
    ref = tmp / "ref"
    _run([sys.executable, "-m", "kge_tpu", "start", str(conf),
          "--folder", str(ref)], cwd=tmp)
    return tmp, port, ref


def test_start_trains_and_resume_continues(started):
    tmp, port, _ = started
    epochs = _entries(port, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == [1, 2]
    assert epochs[1]["avg_loss"] < epochs[0]["avg_loss"]
    assert len(_entries(port, event="eval_completed")) == 1
    assert {"checkpoint_00000.pt", "checkpoint_00001.pt", "checkpoint_00002.pt",
            "checkpoint_best.pt"} <= {p.name for p in port.glob("checkpoint_*.pt")}
    # the folder's config names kge_tpu's modules, as kge_tpu's own does
    with open(port / "config.yaml") as f:
        assert yaml.safe_load(f)["modules"] == [
            "kge_tpu.job", "kge_tpu.models", "kge_tpu.models.embedder"]
    _run([sys.executable, "-m", "kge_tpu_torch", "resume", str(port),
          "--job.device", "cpu", "--train.max_epochs", "3"], cwd=tmp)
    epochs = _entries(port, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == [1, 2, 3]
    resumed = _entries(port, event="job_resumed", job="train")
    assert [e["epoch"] for e in resumed] == [2]
    from kge_tpu_torch.utils.io import load_checkpoint

    checkpoint = load_checkpoint(str(port / "checkpoint_00003.pt"))
    assert checkpoint["epoch"] == 3
    assert int(checkpoint["optimizer_state"]["step"]) == 6  # 2 batches an epoch


def test_start_without_card_fails_unless_cpu_is_asked(started):
    tmp, _, _ = started
    proc = _run([sys.executable, "-m", "kge_tpu_torch", "start",
                 str(tmp / "toy.yaml"), "--folder", str(tmp / "auto"),
                 "--job.device", "auto"], cwd=tmp, check=False)
    if torch.cuda.is_available():
        assert proc.returncode == 0, proc.stderr
    else:
        assert proc.returncode != 0
        assert "needs a CUDA card" in proc.stderr


def test_create_makes_the_folder_and_runs_nothing(started):
    tmp, _, _ = started
    _run([sys.executable, "-m", "kge_tpu_torch", "create", str(tmp / "toy.yaml"),
          "--folder", str(tmp / "created")], cwd=tmp)
    assert (tmp / "created" / "config.yaml").is_file()
    assert not list((tmp / "created").glob("checkpoint_*.pt"))
    # resume on a folder without a checkpoint starts from scratch
    _run([sys.executable, "-m", "kge_tpu_torch", "resume", str(tmp / "created"),
          "--train.max_epochs", "1"], cwd=tmp)
    assert [e["epoch"] for e in _entries(tmp / "created",
                                         event="epoch_completed")] == [1]
    # an existing folder is refused
    proc = _run([sys.executable, "-m", "kge_tpu_torch", "start",
                 str(tmp / "toy.yaml"), "--folder", str(tmp / "created")],
                cwd=tmp, check=False)
    assert proc.returncode != 0 and "exists already" in proc.stderr


def test_kge_tpu_loads_and_resumes_the_ports_checkpoint(started):
    import numpy as np

    from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint
    from kge_tpu_torch.utils.io import load_checkpoint

    tmp, port, _ = started
    name = "checkpoint_00002.pt"
    theirs = jax_load_checkpoint(str(port / name))
    ours = load_checkpoint(str(port / name))
    assert theirs["type"] == "train" and theirs["epoch"] == 2
    assert theirs["config"].get("modules") == [
        "kge_tpu.job", "kge_tpu.models", "kge_tpu.models.embedder"]
    for key in ("entity_embedder", "relation_embedder"):
        np.testing.assert_array_equal(theirs["model"][0][key]["embeddings"],
                                      ours["model"][0][key]["embeddings"])
    assert [sorted(leaf) for leaf in theirs["optimizer_state"]["leaves"]] == [
        ["sum"], ["sum"]]
    copy = tmp / "port_copy"
    import shutil

    shutil.copytree(port, copy)
    for extra in copy.glob("checkpoint_00003.pt"):
        extra.unlink()
    _run([sys.executable, "-m", "kge_tpu", "resume", str(copy),
          "--train.max_epochs", "4"], cwd=tmp)
    jobs = [(e["epoch"], e["avg_loss"]) for e in
            _entries(copy, event="epoch_completed")]
    assert [epoch for epoch, _ in jobs][-2:] == [3, 4]
    # Adagrad's sum came along: the loss keeps falling instead of jumping
    assert jobs[-1][1] < jobs[1][1]


def test_port_resumes_a_folder_kge_tpu_trained(started):
    tmp, _, ref = started
    _run([sys.executable, "-m", "kge_tpu_torch", "resume", str(ref),
          "--job.device", "cpu", "--train.max_epochs", "3"], cwd=tmp)
    epochs = _entries(ref, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == [1, 2, 3]
    assert epochs[2]["avg_loss"] < epochs[0]["avg_loss"]
    # and kge_tpu goes on from there
    _run([sys.executable, "-m", "kge_tpu", "resume", str(ref),
          "--train.max_epochs", "4"], cwd=tmp)
    assert [e["epoch"] for e in _entries(ref, event="epoch_completed")][-1] == 4


@pytest.mark.parametrize("which", ["port", "ref"])
def test_valid_agrees_on_either_folder(started, which):
    tmp, port, ref = started
    folder = port if which == "port" else ref
    before = len(_entries(folder, event="eval_completed", job="eval"))
    _run([sys.executable, "-m", "kge_tpu", "valid", str(folder),
          "--checkpoint", "2"], cwd=tmp)
    _run([sys.executable, "-m", "kge_tpu_torch", "valid", str(folder),
          "--job.device", "cpu", "--checkpoint", "2"], cwd=tmp)
    entries = _entries(folder, event="eval_completed", job="eval")[before:]
    assert len(entries) == 2
    want, got = _metrics(entries[0]), _metrics(entries[1])
    assert want and got == want


# -- the distance models: pooled negatives, Adam, checkpoints both ways ---------


def _pooled_options(model):
    options = {
        "job": {"device": "cpu"},
        "model": model,
        "dataset": {"name": str(DATASET_DIR)},
        "train": {"type": "negative_sampling", "max_epochs": 3, "batch_size": 6,
                  "checkpoint": {"every": 1}},
        "negative_sampling": {"num_samples": {"s": 16}, "pool_factor": 3},
        "lookup_embedder": {"dim": 8},
        "valid": {"every": 0},
        "console": {"quiet": True},
        "random_seed": {"default": 5},
    }
    if model == "rotate":
        options["train"].update(
            loss="bce_self_adversarial",
            optimizer={"default": {"type": "Adam", "args": {"lr": 0.05}}})
    else:
        options["train"].update(
            loss="margin_ranking", loss_arg=4.0,
            optimizer={"default": {"type": "Adagrad", "args": {"lr": 0.5}}})
    return options


@pytest.fixture(scope="module", params=["transe", "rotate"])
def started_pooled(request, tmp_path_factory):
    """(model, tmp, folder the port trained for 3 epochs, folder kge_tpu
    trained for 3 epochs) from one config file with
    ``negative_sampling.implementation: auto``."""
    tmp = tmp_path_factory.mktemp("torch_cli_" + request.param)
    conf = tmp / "toy.yaml"
    with open(conf, "w") as f:
        yaml.safe_dump(_pooled_options(request.param), f)
    port, ref = tmp / "port", tmp / "ref"
    _run([sys.executable, "-m", "kge_tpu_torch", "start", str(conf),
          "--folder", str(port)], cwd=tmp)
    _run([sys.executable, "-m", "kge_tpu", "start", str(conf),
          "--folder", str(ref)], cwd=tmp)
    return request.param, tmp, port, ref


def test_pooled_start_resolves_auto_to_pool_and_learns(started_pooled):
    model, _, port, ref = started_pooled
    for folder in (port, ref):
        assert "Set negative_sampling.implementation=pool" in (
            folder / "kge.log").read_text()
    epochs = _entries(port, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == [1, 2, 3]
    assert epochs[2]["avg_loss"] < epochs[0]["avg_loss"]


def test_pooled_checkpoints_cross_both_ways(started_pooled):
    """The optimizer state of the model's rule (Adagrad's ``sum``, Adam's
    ``m`` and ``v``) is read by the other package, and each resumes the
    other's folder."""
    import numpy as np

    from kge_tpu.utils.io import load_checkpoint as jax_load_checkpoint
    from kge_tpu_torch.utils.io import load_checkpoint

    model, tmp, port, ref = started_pooled
    keys = ["m", "v"] if model == "rotate" else ["sum"]
    theirs = jax_load_checkpoint(str(port / "checkpoint_00003.pt"))
    ours = load_checkpoint(str(port / "checkpoint_00003.pt"))
    assert [sorted(leaf) for leaf in theirs["optimizer_state"]["leaves"]] == [
        keys, keys]
    assert int(theirs["optimizer_state"]["step"]) == 6
    for mine, other in zip(ours["optimizer_state"]["leaves"],
                           theirs["optimizer_state"]["leaves"]):
        for key in keys:
            np.testing.assert_array_equal(np.asarray(mine[key]),
                                          np.asarray(other[key]))
            assert np.abs(np.asarray(mine[key])).max() > 0
    # kge_tpu goes on from the port's folder, then the port from kge_tpu's
    # checkpoint of that folder
    _run([sys.executable, "-m", "kge_tpu", "resume", str(port),
          "--train.max_epochs", "4"], cwd=tmp)
    _run([sys.executable, "-m", "kge_tpu_torch", "resume", str(port),
          "--job.device", "cpu", "--train.max_epochs", "5"], cwd=tmp)
    epochs = _entries(port, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == [1, 2, 3, 4, 5]
    assert epochs[4]["avg_loss"] < epochs[0]["avg_loss"]
    last = load_checkpoint(str(port / "checkpoint_00005.pt"))
    assert int(last["optimizer_state"]["step"]) == 10
    # and the port resumes a folder kge_tpu trained
    _run([sys.executable, "-m", "kge_tpu_torch", "resume", str(ref),
          "--job.device", "cpu", "--train.max_epochs", "4"], cwd=tmp)
    epochs = _entries(ref, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == [1, 2, 3, 4]
    assert epochs[3]["avg_loss"] < epochs[0]["avg_loss"]


def test_kge_tpu_validates_the_ports_distance_model_folder(started_pooled):
    """``valid`` of either package on the folder the port trained (and on
    the one kge_tpu trained) reports the same metrics: the port ranks an L1
    distance model by the score matrix."""
    model, tmp, port, ref = started_pooled
    for folder in (port, ref):
        before = len(_entries(folder, event="eval_completed", job="eval"))
        _run([sys.executable, "-m", "kge_tpu", "valid", str(folder),
              "--checkpoint", "3"], cwd=tmp)
        _run([sys.executable, "-m", "kge_tpu_torch", "valid", str(folder),
              "--job.device", "cpu", "--checkpoint", "3"], cwd=tmp)
        want, got = (_metrics(e) for e in
                     _entries(folder, event="eval_completed", job="eval")[before:])
        assert 0.0 < want["mean_reciprocal_rank_filtered"] <= 1.0
        assert got == want


# -- validation during training of the distance models --------------------------


def _toy_cwd(tmp):
    """A working directory holding the toy dataset where the example
    configs look for it (data/dataset_test)."""
    shutil.copytree(DATASET_DIR, tmp / "data" / "dataset_test")
    return tmp


def test_transe_l1_run_validates_and_keeps_its_checkpoints(tmp_path):
    """TransE-L1 trained for two epochs with a validation at the second:
    the run exits 0, validates, writes the epoch's checkpoint, and its
    validation equals kge_tpu's on the same checkpoint."""
    cwd = _toy_cwd(tmp_path)
    folder = cwd / "c1"
    _run([sys.executable, "-m", "kge_tpu_torch", "start",
          str(EXAMPLES_DIR / "toy-transe-train.yaml"), "--transe.l_norm", "1.0",
          "--train.max_epochs", "2", "--valid.every", "2", "--job.device", "cpu",
          "--folder", str(folder)], cwd=cwd)
    assert {"checkpoint_00002.pt", "checkpoint_best.pt"} <= {
        p.name for p in folder.glob("checkpoint_*.pt")}
    (valid,) = _entries(folder, event="eval_completed", job="eval")
    assert valid["epoch"] == 2 and valid["split"] == "valid"
    assert 0.0 < valid["mean_reciprocal_rank_filtered"] <= 1.0
    _run([sys.executable, "-m", "kge_tpu", "valid", str(folder),
          "--checkpoint", "2"], cwd=cwd)
    assert _metrics(_entries(folder, event="eval_completed", job="eval")[-1]) == (
        _metrics(valid))


def test_transe_l2_example_trains_and_validates(tmp_path):
    """The toy TransE example as it stands (l_norm 2, validation every 5 of
    10 epochs) exits 0 with both validations and their checkpoints."""
    cwd = _toy_cwd(tmp_path)
    folder = cwd / "toy"
    _run([sys.executable, "-m", "kge_tpu_torch", "start",
          str(EXAMPLES_DIR / "toy-transe-train.yaml"), "--job.device", "cpu",
          "--folder", str(folder)], cwd=cwd)
    valid = _entries(folder, event="eval_completed", job="eval")
    assert [e["epoch"] for e in valid] == [5, 10]
    assert all(0.0 < e["mean_reciprocal_rank_filtered"] <= 1.0 for e in valid)
    assert {"checkpoint_00005.pt", "checkpoint_00010.pt", "checkpoint_best.pt"} <= {
        p.name for p in folder.glob("checkpoint_*.pt")}
    epochs = _entries(folder, event="epoch_completed")
    assert [e["epoch"] for e in epochs] == list(range(1, 11))
    assert epochs[-1]["avg_loss"] < epochs[0]["avg_loss"]


@pytest.mark.parametrize("model,extra", [
    ("transe", {"transe": {"l_norm": 2.0}}),
    ("rotate", {"rotate": {"l_norm": 2.0}}),
    ("transh", {"transh": {"C": 0.1}}),
])
def test_port_tests_kge_tpu_distance_model_folders(tmp_path, model, extra):
    """A folder kge_tpu trained (TransE-L2, RotatE-L2, TransH): ``test`` of
    the port reports kge_tpu's own test metrics."""
    options = _pooled_options(model)
    options.update(extra)
    options["train"]["max_epochs"] = 1
    options["train"]["checkpoint"] = {"every": 0}
    conf = tmp_path / "toy.yaml"
    with open(conf, "w") as f:
        yaml.safe_dump(options, f)
    folder = tmp_path / "ref"
    _run([sys.executable, "-m", "kge_tpu", "start", str(conf), "--folder",
          str(folder)], cwd=tmp_path)
    _run([sys.executable, "-m", "kge_tpu", "test", str(folder)], cwd=tmp_path)
    _run([sys.executable, "-m", "kge_tpu_torch", "test", str(folder),
          "--job.device", "cpu"], cwd=tmp_path)
    want, got = (_metrics(e) for e in _eval_entries(folder))
    assert 0.0 < want["mean_reciprocal_rank_filtered"] <= 1.0
    assert got == want


def test_package_imports_neither_jax_nor_kge_tpu():
    pattern = re.compile(
        r"^\s*(import\s+(jax|kge_tpu)\b(?!_torch)|from\s+(jax|kge_tpu)\b(?!_torch))",
        re.M,
    )
    offenders = [
        str(path.relative_to(REPO_ROOT))
        for path in list(PACKAGE_DIR.rglob("*.py")) + [REPO_ROOT / "chip_smoke.py"]
        if pattern.search(path.read_text())
    ]
    assert offenders == []
