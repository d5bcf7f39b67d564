"""The port's ``dump``, ``package`` and ``Trace`` against kge_tpu's, on the
CPU: every mode of tests/test_dump.py (csv, yaml, filters, ``--truncate``,
``--keys`` / ``--keysfile``, ``--checkpoint``, ``--search``, ``dump
checkpoint``, ``dump config``) through both packages' parsers on the same
folders prints the same text; ``Trace`` gives equal ``filter``,
``grep_training_trace_entries`` and ``to_dataframe`` results; and each
package evaluates the other's packaged model to the metrics of the
checkpoint it was packaged from."""

import argparse
import contextlib
import io
import shutil
import sys

import pandas as pd
import pytest
import yaml

import kge_tpu
import kge_tpu_torch
from kge_tpu.job.trace import Trace as JaxTrace
from kge_tpu.utils import dump as jax_dump
from kge_tpu.utils import io as jax_io
from kge_tpu.utils.package import package_model as jax_package
from kge_tpu_torch.job.trace import Trace as TorchTrace
from kge_tpu_torch.utils import dump as torch_dump
from kge_tpu_torch.utils import io as torch_io
from kge_tpu_torch.utils.package import package_model as torch_package
from tests.test_torch_cli import EXAMPLES_DIR, _run, _toy_cwd
from tests.util import DATASET_DIR

PACKAGES = {"kge_tpu": kge_tpu, "kge_tpu_torch": kge_tpu_torch}
DUMPS = {"kge_tpu": jax_dump, "kge_tpu_torch": torch_dump}
IO = {"kge_tpu": jax_io, "kge_tpu_torch": torch_io}


def toy_config(package, folder, **options):
    """tests/test_dump.py's training run: ComplEx on dataset_test, KvsAll,
    lr 0.2, validations with hits at 1 and 3."""
    config = package.Config()
    for key, value in (("console.quiet", True), ("job.device", "cpu"),
                       ("dataset.name", "dataset_test"),
                       ("random_seed.default", 0), ("parallel.data", 1),
                       ("parallel.model", 1)):
        config.set(key, value)
    config.load_options({"model": "complex"})
    for key, value in (("train.type", "KvsAll"), ("train.max_epochs", 2),
                       ("train.batch_size", 6), ("valid.every", 1),
                       ("entity_ranking.hits_at_k_s", [1, 3])):
        config.set(key, value)
    config.set("train.optimizer.default.args.lr", 0.2, create=True)
    for key, value in options.items():
        config.set(key, value, create=True)
    config.folder = str(folder)
    config.init_folder()
    return config


def train_and_resume(name, folder, **options):
    """Two epochs, then a resumed job to epoch 3: a lineage of two jobs."""
    package = PACKAGES[name]
    config = toy_config(package, folder, **options)
    dataset = package.Dataset.create(config, folder=str(DATASET_DIR))
    package.job.Job.create(config, dataset).run()
    checkpoint = IO[name].load_checkpoint(config.checkpoint_file(2))
    config.set("train.max_epochs", 3)
    package.job.Job.create_from(checkpoint, new_config=config,
                                dataset=dataset).run()


def grid_search(name, folder):
    package = PACKAGES[name]
    config = toy_config(package, folder, **{
        "job.type": "search", "search.type": "grid_search",
        "grid_search.parameters": {"train.optimizer.default.args.lr": [0.1, 0.3]},
    })
    dataset = package.Dataset.create(config, folder=str(DATASET_DIR))
    package.job.Job.create(config, dataset).run()


@pytest.fixture(scope="module")
def folders(tmp_path_factory):
    """Folders written by each package: a training run and its resume
    (``train_*``), a grid search (``search_*``); the port's bfloat16 run
    (``bf16``); tests/test_dump.py's hand-made search trace (``synthetic``)."""
    root = tmp_path_factory.mktemp("torch_dump")
    out = {}
    for name in PACKAGES:
        out[f"train_{name}"] = root / f"train_{name}"
        train_and_resume(name, out[f"train_{name}"])
        out[f"search_{name}"] = root / f"search_{name}"
        grid_search(name, out[f"search_{name}"])
    out["bf16"] = root / "bf16"
    train_and_resume("kge_tpu_torch", out["bf16"], **{
        "parallel.param_dtype": "bfloat16", "parallel.compute_dtype": "bfloat16"})
    out["synthetic"] = root / "synthetic"
    out["synthetic"].mkdir()
    rows = [
        {"job": "search", "scope": "train", "folder": "00000",
         "metric_value": 0.1, "epoch": 1},
        {"job": "search", "scope": "train", "folder": "00000",
         "metric_value": 0.3, "epoch": 2},
        {"job": "search", "scope": "train", "folder": "00001",
         "metric_value": 0.2, "epoch": 1},
    ]
    with open(out["synthetic"] / "trace.yaml", "w") as f:
        for row in rows:
            f.write(yaml.dump(row, default_flow_style=True,
                              width=float("inf")).strip() + "\n")
    keysfile = root / "keys.txt"
    keysfile.write_text("# columns\nlr=train.optimizer.default.args.lr\n"
                        "dim=lookup_embedder.dim\n$machine\n\nmetric_value\n")
    out["keysfile"] = keysfile
    return out


def run_dump(name, argv):
    parser = argparse.ArgumentParser()
    subparsers = parser.add_subparsers(dest="command")
    DUMPS[name].add_dump_parsers(subparsers)
    args = parser.parse_args(["dump"] + argv)
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        DUMPS[name].dump(args)
    return out.getvalue()


TRAIN_CASES = {
    "csv": ["trace", "{F}"],
    "yaml": ["trace", "{F}", "--yaml"],
    "train": ["trace", "{F}", "--train", "--yaml"],
    "valid": ["trace", "{F}", "--valid", "--yaml"],
    "test": ["trace", "{F}", "--test"],
    "train_valid_csv": ["trace", "{F}", "--train", "--valid"],
    "truncate": ["trace", "{F}", "--yaml", "--truncate", "2"],
    "keys": ["trace", "{F}", "--train", "-k", "lr=train.optimizer.default.args.lr",
             "model", "$base_model", "$folder", "$machine", "$checkpoint"],
    "no_header": ["trace", "{F}", "--train", "--no-header"],
    "no_default_keys": ["trace", "{F}", "--train", "-K", "-k", "epoch"],
    "list_keys": ["trace", "{F}", "--list-keys"],
    "keysfile": ["trace", "{F}", "--keysfile", "{keysfile}"],
    "checkpoint_source": ["trace", "{F}/checkpoint_00003.pt", "--truncate", "--yaml"],
    "checkpoint_flag": ["trace", "{F}", "--checkpoint", "--truncate", "-k",
                        "$checkpoint"],
    "trace_file": ["trace", "{F}/trace.yaml", "--batch", "--example", "--yaml"],
    "dump_checkpoint": ["checkpoint", "{F}"],
    "dump_checkpoint_file": ["checkpoint", "{F}/checkpoint_00000.pt", "--keys",
                             "epoch", "type"],
    "config": ["config", "{F}"],
    "config_minimal": ["config", "{F}", "--minimal"],
    "config_raw": ["config", "{F}/config.yaml", "--raw"],
    "config_checkpoint": ["config", "{F}/checkpoint_best.pt", "--minimal"],
}
SEARCH_CASES = {
    "search_yaml": ["trace", "{F}", "--search", "--yaml"],
    "search_keys": ["trace", "{F}", "--search", "-k", "folder", "metric_value",
                    "lr=train.optimizer.default.args.lr", "$base_model"],
    "search_csv": ["trace", "{F}", "--search"],
    "search_config": ["config", "{F}", "--minimal"],
}


def _argv(template, folders, folder):
    return [part.replace("{F}", str(folders[folder]))
            .replace("{keysfile}", str(folders["keysfile"])) for part in template]


@pytest.mark.parametrize("case", sorted(TRAIN_CASES))
@pytest.mark.parametrize("folder", ["train_kge_tpu", "train_kge_tpu_torch", "bf16"])
def test_dump_of_a_training_run_equals_kge_tpu(folders, folder, case):
    argv = _argv(TRAIN_CASES[case], folders, folder)
    got = run_dump("kge_tpu_torch", argv)
    assert got == run_dump("kge_tpu", argv)
    assert got.strip() or case == "test"  # no test entries: an empty header


@pytest.mark.parametrize("folder,case", [
    (folder, case) for folder in ("search_kge_tpu", "search_kge_tpu_torch",
                                  "synthetic")
    for case in sorted(SEARCH_CASES)
    if (folder, case) != ("synthetic", "search_config")  # it has no config
])
def test_dump_of_a_search_equals_kge_tpu(folders, folder, case):
    argv = _argv(SEARCH_CASES[case], folders, folder)
    got = run_dump("kge_tpu_torch", argv)
    assert got == run_dump("kge_tpu", argv)


def test_dump_of_a_search_finds_the_port_s_trials(folders):
    """The port's search entries carry ``job: search``, so both dumps list
    each trial with its best validation; kge_tpu's own entries lack it and
    both dumps list none of them (ROADMAP C.4)."""
    rows = {}
    for folder in ("search_kge_tpu", "search_kge_tpu_torch"):
        out = run_dump("kge_tpu_torch", ["trace", str(folders[folder]), "--search",
                                         "--yaml"])
        rows[folder] = [yaml.safe_load(line) for line in out.splitlines() if line]
    assert rows["search_kge_tpu"] == []
    assert len(rows["search_kge_tpu_torch"]) == 2
    for row in rows["search_kge_tpu_torch"]:
        with open(f"{row['folder']}/trace.yaml") as f:
            valid = [e for e in map(yaml.safe_load, f) if e.get("job") == "eval"]
        assert row["metric_value"] == max(e[row["metric_name"]] for e in valid)


def test_dump_checkpoint_names_leaves_in_kge_tpu_s_order(folders):
    """``dump checkpoint`` names the parameters in JAX's pytree order with
    kge_tpu's shapes, bfloat16 checkpoints included."""
    for folder, dim in (("train_kge_tpu", 100), ("bf16", 100)):
        overview = yaml.safe_load(run_dump("kge_tpu_torch",
                                           ["checkpoint", str(folders[folder])]))
        assert overview["parameter_names"] == [
            "_entity_embedder._embeddings.weight",
            "_relation_embedder._embeddings.weight"]
        assert overview["parameter_shapes"][
            "_entity_embedder._embeddings.weight"][0] == 7
        assert overview["num_parameters"] == (7 + 3) * dim


def test_truncate_without_a_checkpoint_raises_in_both(folders):
    for name in DUMPS:
        with pytest.raises(ValueError, match="--truncate"):
            run_dump(name, ["trace", str(folders["train_kge_tpu"]), "--truncate"])


# -- Trace ---------------------------------------------------------------------


@pytest.mark.parametrize("folder", ["train_kge_tpu", "train_kge_tpu_torch"])
def test_trace_equals_kge_tpu(folders, folder):
    tracefile = str(folders[folder] / "trace.yaml")
    traces = {"kge_tpu": JaxTrace(tracefile), "kge_tpu_torch": TorchTrace(tracefile)}
    assert traces["kge_tpu_torch"].entries == traces["kge_tpu"].entries
    for filter_dict in ({}, {"job": "train"}, {"job": "eval", "split": "valid"},
                        {"event": "job_resumed"}):
        assert (traces["kge_tpu_torch"].filter(filter_dict)
                == traces["kge_tpu"].filter(filter_dict))
        pd.testing.assert_frame_equal(
            traces["kge_tpu_torch"].to_dataframe(filter_dict),
            traces["kge_tpu"].to_dataframe(filter_dict))
    assert TorchTrace(tracefile, "job_resumed").entries == JaxTrace(
        tracefile, "job_resumed").entries
    train_jobs = list(dict.fromkeys(
        e["job_id"] for e in traces["kge_tpu"].filter({"job": "train"})))
    assert len(train_jobs) == 2
    for job_id in [None] + train_jobs:
        for flags in ((True, True, False, False), (False, True, True, True),
                      (True, False, False, True)):
            got = TorchTrace.grep_training_trace_entries(tracefile, *flags,
                                                         job_id=job_id)
            want = JaxTrace.grep_training_trace_entries(tracefile, *flags,
                                                        job_id=job_id)
            assert got == want
    lineage = TorchTrace.grep_training_trace_entries(tracefile)
    assert [e["epoch"] for e in lineage if e["job"] == "train"] == [1, 2, 3]


# -- package -------------------------------------------------------------------


def evaluate(name, folder, checkpoint_file):
    """``test <folder> --checkpoint <file>`` of either package, in process:
    the filtered test metrics."""
    package = PACKAGES[name]
    config = package.Config()
    config.load(str(folder / "config.yaml"))
    config.folder = str(folder)
    config.set("job.type", "eval")
    config.set("eval.split", "test")
    dataset = package.Dataset.create(config, folder=str(DATASET_DIR))
    checkpoint = IO[name].load_checkpoint(str(checkpoint_file))
    entry = package.job.Job.create_from(checkpoint, new_config=config,
                                        dataset=dataset).run()
    # NaN (the metric with test triples, not computed on test) as a string,
    # so that equal entries compare equal
    metrics = {k: v if v == v else "nan" for k, v in entry.items()
               if k.startswith(("mean_rank", "mean_reciprocal_rank", "hits_at_"))}
    assert metrics
    return metrics


@pytest.mark.parametrize("source", ["train_kge_tpu", "train_kge_tpu_torch"])
def test_each_package_evaluates_the_other_s_package(folders, tmp_path, source):
    folder = tmp_path / "source"
    shutil.copytree(folders[source], folder)
    checkpoint = folder / "checkpoint_best.pt"
    packaged = {"kge_tpu": jax_package(str(checkpoint), str(tmp_path / "jax.pt")),
                "kge_tpu_torch": torch_package(str(checkpoint),
                                               str(tmp_path / "torch.pt"))}
    for name in PACKAGES:
        overview = yaml.safe_load(run_dump(name, ["checkpoint", packaged[name]]))
        assert overview["type"] == "package"
    for evaluator in PACKAGES:
        want = evaluate(evaluator, folder, checkpoint)
        for packager, file in packaged.items():
            assert evaluate(evaluator, folder, file) == want, (evaluator, packager)


def test_dump_and_package_verbs_run(folders, tmp_path):
    """``python -m kge_tpu_torch dump ...`` and ``package`` exit 0."""
    cwd = _toy_cwd(tmp_path)
    folder = cwd / "run"
    shutil.copytree(folders["train_kge_tpu_torch"], folder)
    proc = _run([sys.executable, "-m", "kge_tpu_torch", "dump", "trace",
                 str(folder), "--valid"], cwd=cwd)
    assert proc.stdout.startswith("job,job_id,")
    _run([sys.executable, "-m", "kge_tpu_torch", "package", str(folder)], cwd=cwd)
    assert (folder / "model_best.pt").exists()
    proc = _run([sys.executable, "-m", "kge_tpu_torch", "dump", "checkpoint",
                 str(folder / "model_best.pt")], cwd=cwd)
    assert yaml.safe_load(proc.stdout)["type"] == "package"
    proc = _run([sys.executable, "-m", "kge_tpu_torch", "dump", "config",
                 str(EXAMPLES_DIR / "toy-complex-train.yaml"), "--raw"], cwd=cwd)
    assert yaml.safe_load(proc.stdout)["model"] == "complex"
