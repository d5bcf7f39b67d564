"""The port's hyperparameter search against kge_tpu's, on the CPU.

Two real searches cannot reach equal metrics: each package draws a trial's
initial weights with its own generator. What is held equal here:

- the trial folders and each trial's ``config.yaml`` of a manual and a grid
  search (``run: False``);
- the search space's mapping, the Sobol points and the GP-EI proposals
  given the same observations (within 1e-12);
- an ``ax_search`` checkpoint written by either package and resumed by the
  other: the same parameters and the same next proposal;
- GraSH's rounds, fidelities, subsets, promotions and best trial, given the
  same trial results;
- core numbers, and the k-core subsets of two copies of one dataset, byte
  for byte.

Trial results are injected by patching each package's trial runner
(``SearchJob._run_train_job``, ``GraSHSearchJob._run_trial``). Real toy
searches run in the port alone: the four example configs, a grid search
and its resume, two CPU workers, and the device pinning of a worker.
"""

import os
import pathlib
import shutil
import sys

import numpy as np
import pytest
import yaml

import kge_tpu
import kge_tpu_torch
from kge_tpu.job import search as jax_search
from kge_tpu.job import search_grash as jax_grash
from kge_tpu.utils import io as jax_io
from kge_tpu.utils import subgraph as jax_subgraph
from kge_tpu_torch.job import search as torch_search
from kge_tpu_torch.job import search_grash as torch_grash
from kge_tpu_torch.utils import io as torch_io
from kge_tpu_torch.utils import subgraph as torch_subgraph
from tests.test_torch_cli import EXAMPLES_DIR, _entries, _run, _toy_cwd
from tests.util import DATASET_DIR, make_synthetic_dataset

PACKAGES = {
    "kge_tpu": (kge_tpu, jax_search, jax_grash, jax_io, jax_subgraph),
    "kge_tpu_torch": (kge_tpu_torch, torch_search, torch_grash, torch_io,
                      torch_subgraph),
}
OTHER = {"kge_tpu": "kge_tpu_torch", "kge_tpu_torch": "kge_tpu"}

# tests/test_search.py's search space and GP observations
SPACE = [
    {"name": "train.optimizer.default.args.lr", "type": "range",
     "bounds": [0.01, 0.5], "log_scale": True, "value_type": "float"},
    {"name": "negative_sampling.num_samples.s", "type": "choice",
     "values": [2, 4]},
]
WIDE_SPACE = [
    {"name": "train.optimizer.default.args.lr", "type": "range",
     "bounds": [0.001, 1.0], "log_scale": True, "value_type": "float"},
    {"name": "negative_sampling.num_samples.s", "type": "range",
     "bounds": [1, 16]},
    {"name": "train.loss", "type": "choice", "values": ["kl", "bce"]},
    {"name": "lookup_embedder.dim", "type": "range", "bounds": [8.0, 32.0],
     "value_type": "int"},
    {"name": "model", "type": "fixed", "value": "complex"},
]


def search_config(package, search_type, folder, **options):
    """tests/test_search.py's ``make_search_config`` for either package."""
    config = package.Config()
    for key, value in (("console.quiet", True), ("job.device", "cpu"),
                       ("dataset.name", "dataset_test"),
                       ("random_seed.default", 0), ("parallel.data", 1),
                       ("parallel.model", 1)):
        config.set(key, value)
    config.load_options({"model": "complex"})
    for key, value in (("job.type", "search"), ("search.type", search_type),
                       ("train.type", "negative_sampling"),
                       ("train.max_epochs", 2), ("train.batch_size", 6),
                       ("valid.every", 2),
                       ("valid.metric", "mean_reciprocal_rank_filtered"),
                       ("entity_ranking.hits_at_k_s", [1, 3])):
        config.set(key, value)
    config.set("complex.entity_embedder.dim", 8, create=True)
    config.set("complex.relation_embedder.dim", 8, create=True)
    for key, value in options.items():
        config.set(key, value, create=True)
    config.folder = str(folder)
    config.init_folder()
    return config


def search_job(name, search_type, folder, dataset_folder=DATASET_DIR,
               **options):
    package = PACKAGES[name][0]
    config = search_config(package, search_type, folder, **options)
    dataset = package.Dataset.create(config, folder=str(dataset_folder))
    return package.job.Job.create(config, dataset)


def objective(parameters):
    """A smooth made-up validation metric of a trial's parameters."""
    lr = parameters["train.optimizer.default.args.lr"]
    s = parameters.get("negative_sampling.num_samples.s", 3)
    return 1.0 - (np.log(lr) - np.log(0.1)) ** 2 / 10.0 - 0.01 * s


@pytest.fixture
def injected(monkeypatch):
    """Both packages' trial runners return ``objective`` as the trial's best
    validation entry, and record the trials they were given."""
    runs = {name: [] for name in PACKAGES}
    for name, (_, search, _, _, _) in PACKAGES.items():
        def run(self, task, device=None, runs=runs[name]):
            trial_no, config, trial_str, parameters = task
            # the options as config.yaml holds them (kge_tpu's module names)
            options = getattr(config, "_shared_options", lambda: config.options)()
            runs.append((trial_no, trial_str, dict(parameters),
                         yaml.safe_load(yaml.dump(options))))
            value = objective(parameters)
            entry = {"mean_reciprocal_rank_filtered": value, "epoch": 2}
            info = dict(folder=config.folder, metric_value=value,
                        metric_name="mean_reciprocal_rank_filtered",
                        **parameters)
            return (trial_no, entry, None, info)

        monkeypatch.setattr(search.SearchJob, "_run_train_job", run)
    return runs


def trial_configs(folder):
    out = {}
    for name in sorted(os.listdir(folder)):
        path = os.path.join(folder, name, "config.yaml")
        if os.path.isfile(path):
            with open(path) as f:
                out[name] = yaml.safe_load(f)
    return out


# -- trial configurations ------------------------------------------------------


@pytest.mark.parametrize("search_type,options", [
    ("manual_search", {"manual_search.run": False,
                       "manual_search.configurations": [
                           {"folder": "lr01", "train.optimizer.default.args.lr": 0.1},
                           {"train.optimizer.default.args.lr": 0.3,
                            "lookup_embedder.dim": 16},
                       ]}),
    ("grid_search", {"grid_search.run": False,
                     "grid_search.parameters": {
                         "train.optimizer.default.args.lr": [0.1, 0.3],
                         "negative_sampling": {"num_samples": {"s": [2, 4]}},
                     }}),
], ids=["manual", "grid"])
def test_trial_folders_and_configs_equal_kge_tpu(tmp_path, injected, search_type,
                                                options):
    """``run: False`` creates the same trial folders; the trials each package
    runs (``run: True``) have equal configurations, and the port's trial
    folders hold them as ``config.yaml`` (kge_tpu's hold none, ROADMAP
    C.4)."""
    folders = {}
    for name in PACKAGES:
        job = search_job(name, search_type, tmp_path / name, **options)
        assert job.run() is None
        folders[name] = sorted(p.name for p in (tmp_path / name).iterdir()
                               if p.is_dir() and p.name != "config")
        run = {**options, search_type.replace("search", "") + "search.run": True}
        search_job(name, search_type, tmp_path / f"{name}_run", **run).run()
    assert len(folders["kge_tpu"]) == (2 if search_type == "manual_search" else 4)
    assert folders["kge_tpu_torch"] == folders["kge_tpu"]
    assert injected["kge_tpu_torch"] == injected["kge_tpu"]
    written = trial_configs(tmp_path / "kge_tpu_torch")
    assert sorted(written) == folders["kge_tpu"]
    for _, trial_str, _, trial_options in injected["kge_tpu"]:
        trial_options["manual_search"]["run"] = False
        if search_type == "grid_search":
            trial_options["grid_search"]["run"] = False
        assert written[trial_str] == trial_options, trial_str


# -- the search space, Sobol points and GP-EI ----------------------------------


def test_search_space_maps_as_kge_tpu_maps():
    rng = np.random.default_rng(5)
    points = np.concatenate([rng.random((200, 4)), np.zeros((1, 4)),
                             np.full((1, 4), 0.999999), np.ones((1, 4))])
    spaces = {name: PACKAGES[name][1].SearchSpace(WIDE_SPACE) for name in PACKAGES}
    assert spaces["kge_tpu_torch"].num_tunable == spaces["kge_tpu"].num_tunable == 4
    for u in points:
        got = spaces["kge_tpu_torch"].from_unit(u)
        want = spaces["kge_tpu"].from_unit(u)
        assert got.keys() == want.keys()
        for key in want:
            assert type(got[key]) is type(want[key]), key
            assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), key


def test_sobol_points_and_gp_ei_proposal_equal_kge_tpu(tmp_path):
    """tests/test_search.py's observations (12 points of a smooth
    objective): ``_sobol_points`` and ``_model_based_point`` within 1e-12,
    and below three observations the seeded random fallback."""
    jobs = {name: search_job(name, "ax_search", tmp_path / name,
                             **{"ax_search.num_trials": 20,
                                "ax_search.num_sobol_trials": 4,
                                "ax_search.parameters": SPACE})
            for name in PACKAGES}
    for job in jobs.values():
        assert job.num_sobol_trials == 4
        for i in range(2):
            job._unit_points[i] = [0.25 + 0.5 * i, 0.5]
            job.results.append({"mean_reciprocal_rank_filtered": 0.1 * i})
    few = {name: job._model_based_point(2) for name, job in jobs.items()}
    np.testing.assert_allclose(few["kge_tpu_torch"], few["kge_tpu"], rtol=0, atol=1e-12)
    for job in jobs.values():
        job._unit_points.clear()
        job.results.clear()
        rng = np.random.default_rng(0)
        opt = np.array([0.7, 0.3])
        for i in range(12):
            u = rng.random(2)
            job._unit_points[i] = [float(x) for x in u]
            job.parameters.append(job.space.from_unit(u))
            job.results.append(
                {"mean_reciprocal_rank_filtered": 1.0 - float(np.sum((u - opt) ** 2))})
    for n, offset in ((4, 0), (512, 13)):
        got = jobs["kge_tpu_torch"]._sobol_points(n, seed_offset=offset)
        want = jobs["kge_tpu"]._sobol_points(n, seed_offset=offset)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    for trial_no in (12, 13):
        got = jobs["kge_tpu_torch"]._model_based_point(trial_no)
        want = jobs["kge_tpu"]._model_based_point(trial_no)
        np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    # minimizing a metric flips the objective the same way
    for job in jobs.values():
        job.config.set("valid.metric_max", False)
    np.testing.assert_allclose(jobs["kge_tpu_torch"]._model_based_point(12),
                               jobs["kge_tpu"]._model_based_point(12),
                               rtol=0, atol=1e-12)


@pytest.mark.parametrize("writer", list(PACKAGES))
def test_ax_checkpoint_resumes_across_packages(tmp_path, injected, writer):
    """The writer runs 4 trials (3 Sobol, 1 GP-EI); the other package
    resumes its checkpoint with 5: the same four parameter sets, and a
    fifth equal to the writer's own resume."""
    options = {"ax_search.num_trials": 4, "ax_search.num_sobol_trials": 3,
               "ax_search.parameters": SPACE}
    job = search_job(writer, "ax_search", tmp_path / "search", **options)
    result = job.run()
    assert len(injected[writer]) == 4
    # both read the checkpoint before either resumed search rewrites it
    checkpoints = {name: PACKAGES[name][3].load_checkpoint(
        job.config.checkpoint_file(1)) for name in PACKAGES}
    proposals = {}
    for name in (OTHER[writer], writer):
        package = PACKAGES[name][0]
        resumed = package.job.Job.create_from(checkpoints[name])
        assert type(resumed).__name__ == "AxSearchJob"
        assert resumed.parameters == job.parameters
        resumed.config.set("ax_search.num_trials", 5)
        resumed._num_trials = 5
        again = resumed.run()
        proposals[name] = resumed.parameters
        assert len(injected[name]) == (5 if name == writer else 1)
        assert again["metric_value"] >= result["metric_value"]
    assert proposals[OTHER[writer]][:4] == job.parameters
    got, want = proposals[OTHER[writer]][4], proposals[writer][4]
    assert got.keys() == want.keys()
    for key in want:
        assert got[key] == pytest.approx(want[key], rel=1e-12, abs=0), key


# -- GraSH ---------------------------------------------------------------------


@pytest.fixture(scope="module")
def synth_copies(tmp_path_factory):
    """Two copies of one synthetic dataset, one for each package (the k-core
    subsets are written into the dataset's folder)."""
    root = tmp_path_factory.mktemp("grash")
    source = make_synthetic_dataset(root / "source" / "synth_grash",
                                    num_entities=48, num_relations=4,
                                    num_train=400, seed=2)
    copies = {}
    for name in PACKAGES:
        copies[name] = root / name / "synth_grash"
        shutil.copytree(source, copies[name])
    return copies


def test_core_numbers_equal_kge_tpu():
    rng = np.random.default_rng(7)
    for n, m in ((1, 0), (5, 3), (40, 120), (300, 2000)):
        edges = rng.integers(0, n, (m, 2))
        got = torch_subgraph.core_numbers(n, edges)
        want = jax_subgraph.core_numbers(n, edges)
        assert got.dtype == want.dtype
        np.testing.assert_array_equal(got, want)
    assert torch_subgraph.core_numbers(
        4, np.array([[0, 1], [1, 2], [2, 0], [3, 0]])).tolist() == [2, 2, 2, 1]


def test_kcore_subsets_equal_kge_tpu_byte_for_byte(synth_copies):
    stats = {}
    for name, folder in synth_copies.items():
        package, _, _, _, subgraph = PACKAGES[name]
        config = package.Config()
        config.set("console.quiet", True)
        config.set("dataset.name", "synth_grash")
        dataset = package.Dataset.create(config, folder=str(folder))
        stats[name] = subgraph.KCoreManager(config, dataset).decompose(
            valid_frac=0.2, valid_max=50, seed=3)
    assert len(stats["kge_tpu"]) >= 3
    for got, want in zip(stats["kge_tpu_torch"], stats["kge_tpu"], strict=True):
        assert got["folder"] == want["folder"].replace(
            str(synth_copies["kge_tpu"]), str(synth_copies["kge_tpu_torch"]))
        assert {k: v for k, v in got.items() if k != "folder"} == {
            k: v for k, v in want.items() if k != "folder"}
    files = {}
    for name, folder in synth_copies.items():
        subsets = folder / "subsets"
        files[name] = {
            str(path.relative_to(subsets)): path.read_bytes()
            .replace(str(folder).encode(), b"<dataset>")
            for path in sorted(subsets.rglob("*")) if path.is_file()}
    assert "subset_stats.yaml" in files["kge_tpu"]
    assert len(files["kge_tpu"]) == 1 + 6 * len(stats["kge_tpu"])
    assert files["kge_tpu_torch"] == files["kge_tpu"]


@pytest.mark.parametrize("variant", ["combined", "epoch"])
def test_grash_decisions_equal_kge_tpu(tmp_path, synth_copies, monkeypatch, variant):
    """GraSH with the same injected trial results: the same rounds, epochs,
    subsets, promotions, cache and best trial."""
    calls = {name: [] for name in PACKAGES}
    for name, (_, _, grash, _, _) in PACKAGES.items():
        def run_trial(self, trial_id, parameters, round_idx, epochs, subset,
                      metric_name, calls=calls[name]):
            calls.append((trial_id, round_idx, epochs,
                          None if subset is None else subset["k"],
                          dict(parameters)))
            return objective(parameters) + 0.01 * round_idx
        monkeypatch.setattr(grash.GraSHSearchJob, "_run_trial", run_trial)
    results = {}
    for name in PACKAGES:
        job = search_job(
            name, "grash_search", tmp_path / name, synth_copies[name],
            **{"dataset.name": "synth_grash", "grash_search.num_trials": 4,
               "grash_search.eta": 2, "grash_search.search_budget": 2,
               "grash_search.variant": variant, "grash_search.seed": 3,
               "grash_search.valid_max": 50,
               "grash_search.parameters": SPACE, "train.max_epochs": 4})
        results[name] = (job.run(), dict(job.trial_cache))
    assert len(calls["kge_tpu"]) == 4 + 2
    if variant == "combined":
        assert any(call[3] is not None for call in calls["kge_tpu"])
    assert calls["kge_tpu_torch"] == calls["kge_tpu"]
    assert results["kge_tpu_torch"] == results["kge_tpu"]


# -- real searches in the port ---------------------------------------------------


@pytest.mark.parametrize("example,options", [
    ("manual", ["--train.max_epochs", "2"]),
    ("grid", ["--train.max_epochs", "2"]),
    # both examples draw odd dimensions, which ComplEx cannot split; kge_tpu's
    # trials fail on them too (ROADMAP C.4)
    ("ax", ["--search.on_error", "continue"]),
    ("grash", ["--search.on_error", "continue"]),
])
def test_example_searches_run_to_their_end(tmp_path, example, options):
    cwd = _toy_cwd(tmp_path)
    folder = cwd / "search"
    _run([sys.executable, "-m", "kge_tpu_torch", "start",
          str(EXAMPLES_DIR / f"toy-complex-search-{example}.yaml"),
          "--job.device", "cpu", "--folder", str(folder), *options], cwd=cwd)
    (done,) = _entries(folder, event="search_completed", scope="search")
    assert np.isfinite(done["metric_value"])


def test_grid_search_runs_and_resumes(tmp_path):
    """The toy grid search through the command line, then ``resume`` with one
    more epoch: every trial goes on from its checkpoint. The grid's keys
    are given in sorted order: trial folders are named in the grid's order,
    and ``config.yaml`` stores the keys sorted, so a grid in another order
    would resume into new folders, in kge_tpu as in the port (ROADMAP
    C.4)."""
    cwd = _toy_cwd(tmp_path)
    folder = cwd / "grid"
    with open(EXAMPLES_DIR / "toy-complex-search-grid.yaml") as f:
        options = yaml.safe_load(f)
    grid = options.pop("grid_search.parameters")
    options["grid_search.parameters"] = {
        "lookup_embedder.dim": grid["lookup_embedder"]["dim"],
        "train.optimizer.default.args.lr": grid["train.optimizer.default.args.lr"]}
    example = cwd / "grid.yaml"
    example.write_text(yaml.safe_dump(options, sort_keys=False))
    _run([sys.executable, "-m", "kge_tpu_torch", "start", str(example),
          "--job.device", "cpu", "--train.max_epochs", "2", "--folder",
          str(folder)], cwd=cwd)
    trials = sorted(p for p in folder.iterdir() if p.name.startswith("loo_"))
    assert len(trials) == 4
    first = _entries(folder, event="search_completed", scope="train")
    assert sorted(e["folder"] for e in first) == [str(p) for p in trials]
    for entry in first:
        valid = _entries(pathlib.Path(entry["folder"]), job="eval")
        assert entry["metric_value"] == max(e[entry["metric_name"]] for e in valid)
    _run([sys.executable, "-m", "kge_tpu_torch", "resume", str(folder),
          "--train.max_epochs", "3"], cwd=cwd)
    for trial in trials:
        assert (trial / "checkpoint_00003.pt").exists()
        (resumed,) = _entries(trial, event="job_resumed")
        assert resumed["epoch"] == 2
    assert len(_entries(folder, event="search_completed", scope="train")) == 8
    assert len(_entries(folder, event="search_completed", scope="search")) == 2


def test_two_cpu_workers_run_every_trial(tmp_path):
    """``search.num_workers: 2`` with ``--search.device_pool cpu,cpu``: the
    trials run in two spawned worker processes, each holding one slot of the
    pool, and the parent writes every trial's search entry."""
    cwd = _toy_cwd(tmp_path)
    folder = cwd / "grid"
    _run([sys.executable, "-m", "kge_tpu_torch", "start",
          str(EXAMPLES_DIR / "toy-complex-search-grid.yaml"), "--job.device",
          "cpu", "--train.max_epochs", "2", "--search.num_workers", "2",
          "--search.device_pool", "cpu,cpu", "--folder", str(folder)], cwd=cwd)
    locks = sorted((folder / ".device_locks").iterdir())
    pids = {path.read_text().split()[0] for path in locks}
    assert [path.read_text().split()[1] for path in locks] == ["cpu", "cpu"]
    assert len(pids) == 2
    seen = set()
    for trial in folder.glob("tra_*"):
        log = (trial / "kge.log").read_text()
        (line,) = [l for l in log.splitlines() if " runs on " in l]
        assert " runs on cpu in process " in line
        seen.add(line.split()[-1])
    assert seen <= pids
    assert len(_entries(folder, event="search_completed", scope="train")) == 4


@pytest.mark.parametrize("device,visible,trial", [
    ("cuda:1", "1", "cuda:0"), ("cpu", None, "cpu"), ("auto", None, None),
    (None, None, None), ("cuda", None, None),
])
def test_pin_device(monkeypatch, device, visible, trial):
    """A worker pinned to ``cuda:<n>`` sees that card alone, as cuda:0; the
    port sets no JAX or TPU variable."""
    monkeypatch.delenv("CUDA_VISIBLE_DEVICES", raising=False)
    monkeypatch.setenv("JAX_PLATFORMS", "cpu")
    before = dict(os.environ)
    torch_search._pin_device(device)
    after = dict(os.environ)
    assert after.pop("CUDA_VISIBLE_DEVICES", None) == visible
    assert after == before
    assert torch_search._trial_device(device) == trial
