"""The port's command line on a folder that kge_tpu trained: ``python -m
kge_tpu_torch test <folder> --job.device cpu`` reports kge_tpu's own test
metrics and loads neither jax nor any module of kge_tpu; with no card,
``job.device: auto`` fails loudly instead of running on the host."""

import json
import os
import pathlib
import re
import subprocess
import sys

import pytest
import torch
import yaml

from tests.util import DATASET_DIR, TESTS_DIR

REPO_ROOT = TESTS_DIR.parent
PACKAGE_DIR = REPO_ROOT / "kge_tpu_torch"

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


def test_verbs_not_ported_exit_nonzero(tmp_path):
    proc = _run([sys.executable, "-m", "kge_tpu_torch", "start", "x.yaml"],
                cwd=tmp_path, check=False)
    assert proc.returncode != 0
    assert "not ported yet" in proc.stderr


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
