"""Hyperparameter search jobs (kge_tpu/job/search.py; reference
kge/job/search*.py): trial scheduling over a worker pool, manual and grid
search, the generic propose/observe auto-search loop with its own
checkpointing, a quasi-random (Sobol) + GP-EI search job covering the
reference's ax_search surface, and GraSH-style successive halving (see
search_grash.py). Trial folders, configurations, Sobol points and GP-EI
proposals are kge_tpu's, and either package resumes the other's search
checkpoint.

Trials run in-process by default (one card per host); with
``search.num_workers > 1`` trials run in spawned worker processes, each
pinned to a device of ``search.device_pool`` before torch touches CUDA.
"""

from __future__ import annotations

import copy
import gc
import os
from typing import Any, Dict, List, Optional, Tuple

import numpy as np
import torch

from kge_tpu_torch import misc
from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.job.job import Job
from kge_tpu_torch.utils.io import load_checkpoint, save_checkpoint


class SearchJob(Job):
    """Base class of jobs for hyperparameter search (reference search.py).

    Provides ``submit_task``/``wait_task`` trial scheduling; results are
    (trial_index, best_valid_trace, train_trace) tuples.
    """

    def __init__(self, config: Config, dataset: Dataset, parent_job=None):
        super().__init__(config, dataset, parent_job)
        self.num_workers = self.config.get("search.num_workers")
        self.on_error = self.config.check(
            "search.on_error", ["abort", "continue"]
        )
        self.device_pool: List[str] = list(config.get("search.device_pool"))
        if not self.device_pool:
            self.device_pool = [config.get("job.device")]
        self._running: List = []
        self.ready_task_results: List[Tuple] = []

        if self.__class__ == SearchJob:
            for f in Job.job_created_hooks:
                f(self)

    @staticmethod
    def create(config: Config, dataset: Dataset, parent_job=None) -> "SearchJob":
        search_type = config.get("search.type")
        class_name = config.get_default(search_type + ".class_name")
        return misc.init_from(
            class_name, config.get("modules"), config, dataset,
            parent_job=parent_job,
        )

    # -- trial scheduling ------------------------------------------------------

    def submit_task(self, task, wait_when_full: bool = True):
        """Run or enqueue a trial ``(trial_no, config, trial_str, kwargs)``.

        With ``search.num_workers <= 1`` the trial runs in-process on this
        process's device. Otherwise trials are shipped (everything in the
        tuple is picklable: ``Config`` is a plain options dict) to a
        spawn-context worker pool (CUDA cannot be forked once it has
        started); each worker process checks one device out of
        ``search.device_pool`` before torch touches CUDA, so trials run
        concurrently on their devices."""
        if self.num_workers <= 1:
            self._handle_task_result(self._run_train_job(task))
        else:
            import concurrent.futures

            if not hasattr(self, "_executor"):
                import multiprocessing

                lock_dir = os.path.join(
                    self.config.folder or ".", ".device_locks"
                )
                if os.path.isdir(lock_dir):
                    for f in os.listdir(lock_dir):
                        os.unlink(os.path.join(lock_dir, f))
                pool = list(self.device_pool)
                while len(pool) < self.num_workers:
                    pool.extend(self.device_pool)
                self._executor = concurrent.futures.ProcessPoolExecutor(
                    max_workers=self.num_workers,
                    mp_context=multiprocessing.get_context("spawn"),
                    initializer=_worker_initializer,
                    initargs=(pool, lock_dir),
                )
            if wait_when_full and len(self._running) >= self.num_workers:
                self.wait_task()
            share = self._share_dataset(task[1])
            future = self._executor.submit(
                _execute_trial, task, self.on_error,
                self.dataset.folder if share else None,
            )
            self._running.append(future)

    def wait_task(self, return_when="FIRST_COMPLETED"):
        """Wait for at least one running task; collect its result."""
        if self._running:
            import concurrent.futures

            done, not_done = concurrent.futures.wait(
                self._running,
                return_when=getattr(concurrent.futures, return_when),
            )
            self._running = list(not_done)
            for f in done:
                self._handle_task_result(f.result())

    def close_workers(self):
        """Shut down the worker pool (called when all trials finished)."""
        if hasattr(self, "_executor"):
            self._executor.shutdown(wait=True)
            del self._executor

    def _handle_task_result(self, result):
        """Record a finished trial: emit its search trace entry (always from
        the search process: workers must not append to the parent's trace
        file concurrently) and queue the result tuple.

        The entry carries this job's ``job: search`` and ids, which
        ``dump trace --search`` selects it by; kge_tpu writes it without
        them, so its dump finds no trial of a search it ran (ROADMAP
        C.4)."""
        trial_no, best_entry, train_trace, trace_info = result
        if trace_info is not None:
            self.trace(
                event="search_completed",
                echo=True, echo_prefix="  ", log=True,
                scope="train",
                **trace_info,
            )
        self.ready_task_results.append((trial_no, best_entry, train_trace))

    # -- single-trial runner (reference search.py:107-232) --------------------

    def _run_train_job(self, sicnk):
        """Run one search trial in-process; see ``_execute_trial``."""
        share = self._share_dataset(sicnk[1])
        return _execute_trial(
            sicnk, self.on_error,
            dataset=self.dataset.shallow_copy() if share else None,
            parent_job=self,
        )

    def _share_dataset(self, trial_config: Config) -> bool:
        """Trials on the same dataset share the in-memory Dataset."""
        try:
            return trial_config.get("dataset.name") == self.config.get(
                "dataset.name"
            )
        except KeyError:
            return False


def init_trial_folder(config: Config) -> None:
    """Create a trial's folder with its ``config.yaml`` and ``config/``, as
    ``Config.init_folder`` does for a new folder, unless the trial has its
    config already. kge_tpu creates the folder first, which makes its
    ``init_folder`` a no-op: its trial folders hold no ``config.yaml``, so
    none of its trials can be resumed, tested or packaged from the command
    line (ROADMAP C.4)."""
    if not os.path.isfile(os.path.join(config.folder, "config.yaml")):
        os.makedirs(os.path.join(config.folder, "config"), exist_ok=True)
        config.save(os.path.join(config.folder, "config.yaml"))


# -- worker-process machinery --------------------------------------------------
#
# Parallel trials (search.num_workers > 1) run in spawn-context worker
# processes. Everything submitted must be picklable, so the unit of work is
# the plain ``(trial_no, config, trial_str, kwargs)`` tuple and a module-level
# function. Device pinning happens in the pool initializer: each worker
# atomically checks one device out of ``search.device_pool`` via a lock file
# and restricts its process to that device BEFORE torch initializes CUDA
# (reference kge/job/search.py:36-97 does the same with a multiprocessing
# pool + torch device strings).

_WORKER_DEVICE: Optional[str] = None


def _checkout_device(device_pool: List[str], lock_dir: str) -> Optional[str]:
    """Atomically claim a device slot from the pool (one per worker)."""
    os.makedirs(lock_dir, exist_ok=True)
    for i, dev in enumerate(device_pool):
        path = os.path.join(lock_dir, f"slot{i:03d}.lock")
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            continue
        os.write(fd, f"{os.getpid()} {dev}\n".encode())
        os.close(fd)
        return dev
    return None


def _pin_device(device: Optional[str]):
    """Restrict this process to ``device`` before torch initializes CUDA.

    'cuda:<n>' makes only card ``n`` visible to the process
    (``CUDA_VISIBLE_DEVICES``), where it is then ``cuda:0``
    (``_trial_device``); 'cpu', 'cuda' and 'auto' change nothing here."""
    platform, _, index = (device or "").partition(":")
    if platform == "cuda" and index:
        os.environ["CUDA_VISIBLE_DEVICES"] = index


def _trial_device(device: Optional[str]) -> Optional[str]:
    """The ``job.device`` of a trial in a worker pinned to ``device``, as
    the worker sees it: 'cpu' stays, 'cuda:<n>' is 'cuda:0'; None keeps
    the trial's own."""
    platform, _, index = (device or "").partition(":")
    if platform == "cpu":
        return "cpu"
    if platform == "cuda" and index:
        return "cuda:0"
    return None


def _worker_initializer(device_pool: List[str], lock_dir: str):
    global _WORKER_DEVICE
    _WORKER_DEVICE = _checkout_device(device_pool, lock_dir)
    _pin_device(_WORKER_DEVICE)


def _log_allocator(config: Config, trial_str: str):
    """Log what the CUDA allocator holds after a trial, and its peak during
    the trial, so that a trial holding its predecessor's tables shows."""
    if not torch.cuda.is_initialized():
        return
    config.log(
        f"Trial {trial_str} done: CUDA memory allocated "
        f"{torch.cuda.memory_allocated() / 2**20:.1f} MiB, peak "
        f"{torch.cuda.max_memory_allocated() / 2**20:.1f} MiB"
    )
    torch.cuda.reset_peak_memory_stats()


def _execute_trial(
    sicnk,
    on_error: str = "abort",
    dataset_folder: Optional[str] = None,
    dataset: Optional[Dataset] = None,
    parent_job=None,
):
    """Run one search trial: ``(trial_no, config, trial_str, kwargs)``.

    Runs in the search process (``_run_train_job``) or a pinned worker.
    Returns ``(trial_no, best_valid_trace_entry or None, train_trace,
    trace_info or None)``; the caller emits the ``search_completed`` trace
    entry from ``trace_info`` so only the search process appends to the
    search trace file.
    """
    trial_no, config, trial_str, kwargs = sicnk
    try:
        device = _trial_device(_WORKER_DEVICE)
        if device is not None:
            config.set("job.device", device)
        init_trial_folder(config)
        # resume if a checkpoint exists
        checkpoint_file = None
        last = config.last_checkpoint_number()
        if last is not None:
            checkpoint_file = config.checkpoint_file(last)

        config.log(
            "Starting training job {} ({}) ...".format(
                trial_str, config.folder
            )
        )
        if dataset is None and dataset_folder is not None:
            dataset = Dataset.create(config, folder=dataset_folder)
        if checkpoint_file is not None:
            checkpoint = load_checkpoint(checkpoint_file)
            job = Job.create_from(checkpoint, new_config=config)
        else:
            job = Job.create(config, dataset=dataset)
        job.parent_job = parent_job
        config.log(
            f"Trial {trial_str} runs on {job.device} in process {os.getpid()}"
        )
        job.run()

        # locate the best validation trace entry for the search trace
        valid_trace = getattr(job, "valid_trace", [])
        metric_name = config.get("valid.metric")
        best_entry = None
        trace_info = None
        if valid_trace:
            metric_max = config.get("valid.metric_max")
            values = [t.get(metric_name, float("nan")) for t in valid_trace]
            values = np.asarray(values, dtype=float)
            idx = int(np.nanargmax(values) if metric_max else
                      np.nanargmin(values))
            best_entry = dict(valid_trace[idx])
            trace_info = dict(
                train_job_id=job.job_id,
                folder=config.folder,
                metric_value=float(values[idx]),
                metric_name=metric_name,
                **{k: v for k, v in kwargs.items()},
            )
        del job
        gc.collect()
        _log_allocator(config, trial_str)
        return (trial_no, best_entry, None, trace_info)
    except BaseException as e:
        config.log(f"Trial {trial_str} failed: {e!r}")
        if on_error == "continue":
            return (trial_no, None, None, None)
        raise


class ManualSearchJob(SearchJob):
    """Train with manually specified configurations
    (reference search_manual.py)."""

    def __init__(self, config, dataset, parent_job=None):
        super().__init__(config, dataset, parent_job)
        if self.__class__ == ManualSearchJob:
            for f in Job.job_created_hooks:
                f(self)

    def _run(self):
        configurations = self.config.get("manual_search.configurations")
        self.config.log(f"Running {len(configurations)} configurations...")

        tasks = []
        for i, conf in enumerate(configurations):
            conf = copy.deepcopy(conf)
            folder = conf.pop("folder", str(i).zfill(5))
            trial_config = self.config.clone(folder)
            trial_config.set("job.type", "train")
            flat = Config.flatten(conf)
            trial_config.load_options(flat, create=True)
            tasks.append((i, trial_config, folder, flat))

        if not self.config.get("manual_search.run"):
            for _, trial_config, _, _ in tasks:
                init_trial_folder(trial_config)
            self.config.log(
                "Created trial folders; manual_search.run=False, stopping."
            )
            return None

        for task in tasks:
            self.submit_task(task)
        while self._running:
            self.wait_task()
        self.close_workers()

        # summarize
        results = sorted(self.ready_task_results, key=lambda r: r[0])
        best = None
        metric_name = self.config.get("valid.metric")
        metric_max = self.config.get("valid.metric_max")
        for trial_no, best_entry, _ in results:
            if best_entry is None:
                continue
            value = best_entry.get(metric_name)
            if best is None or (
                value is not None
                and (value > best[1] if metric_max else value < best[1])
            ):
                best = (trial_no, value)
        if best is not None:
            self.config.log(
                f"Best trial: {best[0]} with {metric_name}={best[1]}"
            )
            self.trace(
                event="search_completed", scope="search",
                best_trial=best[0], metric_value=best[1],
                metric_name=metric_name,
            )
        return results


class GridSearchJob(SearchJob):
    """Cartesian-product grid search, delegated to a manual search
    (reference search_grid.py)."""

    def __init__(self, config, dataset, parent_job=None):
        super().__init__(config, dataset, parent_job)
        if self.__class__ == GridSearchJob:
            for f in Job.job_created_hooks:
                f(self)

    def _run(self):
        import itertools

        grid = Config.flatten(self.config.get("grid_search.parameters"))
        if not grid:
            raise ValueError("grid_search.parameters is empty")
        keys = list(grid.keys())
        value_lists = [
            v if isinstance(v, list) else [v] for v in grid.values()
        ]

        def abbreviate(key: str, value) -> str:
            short = "_".join(part[0:3] for part in key.split("."))
            return f"{short}={value}"

        configurations = []
        for values in itertools.product(*value_lists):
            entry: Dict[str, Any] = {}
            name_parts = []
            for k, v in zip(keys, values):
                entry[k] = v
                name_parts.append(abbreviate(k, v))
            entry["folder"] = "-".join(name_parts)
            configurations.append(entry)
        self.config.log(
            f"Grid search with {len(configurations)} configurations"
        )
        self.config.set(
            "manual_search.configurations", configurations, create=True
        )
        self.config.set("manual_search.run", self.config.get("grid_search.run"))
        manual = ManualSearchJob(self.config, self.dataset, parent_job=self)
        return manual._run()


# -- search-space handling (reference util/configspace_converter.py syntax) ---


class SearchSpace:
    """Ax-style search-space definition: a list of dicts with ``name``,
    ``type`` (choice | range | fixed), ``values`` or ``bounds``, and optional
    ``log_scale`` / ``value_type``."""

    def __init__(self, parameters: List[Dict[str, Any]]):
        self.parameters = parameters
        self.tunable = [p for p in parameters if p["type"] != "fixed"]

    @property
    def num_tunable(self) -> int:
        return len(self.tunable)

    def from_unit(self, u: np.ndarray) -> Dict[str, Any]:
        """Map a point of the unit hypercube to a configuration dict."""
        out: Dict[str, Any] = {}
        i = 0
        for p in self.parameters:
            if p["type"] == "fixed":
                out[p["name"]] = p["value"]
                continue
            x = float(u[i])
            i += 1
            if p["type"] == "choice":
                values = p["values"]
                idx = min(int(x * len(values)), len(values) - 1)
                out[p["name"]] = values[idx]
            elif p["type"] == "range":
                lo, hi = p["bounds"]
                if p.get("log_scale", False):
                    value = float(
                        np.exp(np.log(lo) + x * (np.log(hi) - np.log(lo)))
                    )
                else:
                    value = lo + x * (hi - lo)
                if p.get("value_type") == "int" or (
                    isinstance(lo, int) and isinstance(hi, int)
                    and p.get("value_type") != "float"
                ):
                    value = int(round(value))
                    value = max(lo, min(hi, value))
                out[p["name"]] = value
            else:
                raise ValueError(f"unknown parameter type {p['type']}")
        return out


class AutoSearchJob(SearchJob):
    """Generic propose/observe search with its own checkpointing so the
    search itself can resume (reference search_auto.py)."""

    def __init__(self, config, dataset, parent_job=None):
        super().__init__(config, dataset, parent_job)
        self.parameters: List[Dict[str, Any]] = []
        self.results: List[Optional[Dict[str, Any]]] = []
        if self.__class__ == AutoSearchJob:
            for f in Job.job_created_hooks:
                f(self)

    # checkpoint of the search state
    def save(self, filename):
        self.config.log(f"Saving search checkpoint to {filename}")
        save_checkpoint(
            {
                "type": "search",
                "parameters": self.parameters,
                "results": self.results,
                "job_id": self.job_id,
                "config": self.config,
                "subclass_state": self._subclass_state(),
            },
            filename,
        )

    def _load(self, checkpoint):
        if checkpoint["type"] != "search":
            raise ValueError("can only resume search checkpoints")
        self.parameters = checkpoint["parameters"]
        self.results = checkpoint["results"]
        self.resumed_from_job_id = checkpoint.get("job_id")
        self._load_subclass_state(checkpoint.get("subclass_state", {}))

    def _subclass_state(self) -> Dict[str, Any]:
        """Extra state a concrete search stores in its checkpoint."""
        return {}

    def _load_subclass_state(self, state: Dict[str, Any]):
        pass

    def can_propose_ahead(self, trial_no: int) -> bool:
        """True when trial ``trial_no`` can be proposed before earlier
        results arrive (non-adaptive phases run trials in parallel)."""
        return False

    def register_trial(self, parameters=None) -> Tuple[Optional[Dict], int]:
        """Propose (or replay) the next trial; subclasses implement."""
        raise NotImplementedError

    def register_trial_result(self, trial_id, parameters, trace_entry):
        raise NotImplementedError

    def _collect_ready_results(self):
        for trial_no_r, best_entry, _ in self.ready_task_results:
            self.results[trial_no_r] = best_entry
            self.register_trial_result(
                trial_no_r, self.parameters[trial_no_r], best_entry
            )
        self.ready_task_results = []

    def get_best_parameters(self):
        metric_name = self.config.get("valid.metric")
        metric_max = self.config.get("valid.metric_max")
        values = [
            r.get(metric_name) if r else None for r in self.results
        ]
        valid = [(i, v) for i, v in enumerate(values) if v is not None]
        if not valid:
            return None, None
        best = max(valid, key=lambda t: t[1]) if metric_max else \
            min(valid, key=lambda t: t[1])
        return self.parameters[best[0]], best[1]

    @property
    def num_trials(self) -> int:
        raise NotImplementedError

    def _run(self):
        metric_name = self.config.get("valid.metric")
        # drop incomplete tail trials so they are re-proposed on resume
        # (deterministic proposals regenerate the same parameters)
        while self.results and self.results[-1] is None:
            self.parameters.pop()
            self.results.pop()
        while True:
            trial_no = len(self.parameters)
            if trial_no >= self.num_trials:
                break
            parameters, trial_id = self.register_trial()
            if parameters is None:
                break
            self.parameters.append(parameters)
            self.results.append(None)

            folder = str(trial_no).zfill(5)
            trial_config = self.config.clone(folder)
            trial_config.set("job.type", "train")
            trial_config.load_options(
                copy.deepcopy(parameters), create=True
            )
            self.save(self.config.checkpoint_file(1))

            task = (trial_no, trial_config, folder, parameters)
            self.submit_task(task)
            # adaptive proposals need earlier results; non-adaptive phases
            # (e.g. the Sobol prefix) keep the worker pool saturated
            next_no = trial_no + 1
            if not (
                next_no < self.num_trials
                and self.can_propose_ahead(next_no)
                and len(self._running) < self.num_workers
            ):
                self.wait_task()
            self._collect_ready_results()
            self.save(self.config.checkpoint_file(1))

        while self._running:
            self.wait_task()
            self._collect_ready_results()
        self.close_workers()

        best_params, best_value = self.get_best_parameters()
        self.config.log(
            f"Best result ({metric_name}={best_value}): {best_params}"
        )
        self.trace(
            event="search_completed", scope="search",
            metric_name=metric_name,
            metric_value=best_value,
            best_parameters=best_params,
        )
        self.save(self.config.checkpoint_file(1))
        return {"best_parameters": best_params, "metric_value": best_value}


class AxSearchJob(AutoSearchJob):
    """Quasi-random (Sobol) + Bayesian (GP with expected improvement) search
    over an Ax-style search space.

    Covers the reference AxSearchJob surface (search_ax.py): a fixed-seed
    Sobol phase whose sequence replays deterministically on resume, followed
    by model-based trials. The GP is a plain numpy implementation (RBF
    kernel, lengthscale/noise chosen by marginal likelihood over a small
    grid, EI maximized over a Sobol candidate pool) — no Ax/BoTorch
    dependency. Proposals are a deterministic function of past results, so
    resume replays the whole sequence identically.
    """

    def __init__(self, config, dataset, parent_job=None):
        super().__init__(config, dataset, parent_job)
        self.space = SearchSpace(self.config.get("ax_search.parameters"))
        self._num_trials = self.config.get("ax_search.num_trials")
        num_sobol = self.config.get("ax_search.num_sobol_trials")
        if num_sobol < 0:
            num_sobol = min(self._num_trials, 2 * self.space.num_tunable)
        self.num_sobol_trials = num_sobol
        self.sobol_seed = self.config.get("ax_search.sobol_seed")
        self._unit_points: Dict[int, List[float]] = {}
        if self.__class__ == AxSearchJob:
            for f in Job.job_created_hooks:
                f(self)

    @property
    def num_trials(self):
        return self._num_trials

    def can_propose_ahead(self, trial_no: int) -> bool:
        # the Sobol prefix is fixed ahead of time; GP proposals are adaptive
        return trial_no < self.num_sobol_trials

    def _subclass_state(self):
        return {"unit_points": self._unit_points}

    def _load_subclass_state(self, state):
        self._unit_points = {
            int(k): v for k, v in state.get("unit_points", {}).items()
        }

    def _sobol_points(self, n: int, seed_offset: int = 0) -> np.ndarray:
        from scipy.stats import qmc

        d = max(self.space.num_tunable, 1)
        sampler = qmc.Sobol(
            d=d, scramble=True, seed=self.sobol_seed + seed_offset
        )
        return sampler.random(n)

    def register_trial(self, parameters=None):
        trial_no = len(self.parameters)
        if trial_no < self.num_sobol_trials:
            # regenerate the whole Sobol prefix so resume replays identically
            # (reference search_ax.py:70-92)
            points = self._sobol_points(self.num_sobol_trials)
            u = points[trial_no]
        else:
            u = self._model_based_point(trial_no)
        self._unit_points[trial_no] = [float(x) for x in u]
        return self.space.from_unit(u), trial_no

    def register_trial_result(self, trial_id, parameters, trace_entry):
        pass  # the GP is re-fit from (unit_points, results) at proposal time

    # -- GP + expected improvement ---------------------------------------------

    def _observations(self):
        metric_name = self.config.get("valid.metric")
        X, y = [], []
        for i, result in enumerate(self.results):
            if result is None or i not in self._unit_points:
                continue
            value = result.get(metric_name)
            if value is None or not np.isfinite(value):
                continue
            X.append(self._unit_points[i])
            y.append(float(value))
        return np.asarray(X, dtype=float), np.asarray(y, dtype=float)

    def _model_based_point(self, trial_no: int) -> np.ndarray:
        d = max(self.space.num_tunable, 1)
        X, y = self._observations()
        rng = np.random.default_rng(self.sobol_seed + 7919 * trial_no)
        if len(y) < 3 or np.std(y) < 1e-12:
            return rng.random(d)
        if not self.config.get("valid.metric_max"):
            y = -y  # EI is written for maximization
        y_mean, y_std = float(np.mean(y)), float(np.std(y))
        y_n = (y - y_mean) / y_std

        # kernel hyperparameters by log marginal likelihood over a grid
        best = None
        for ls in (0.1, 0.2, 0.4, 0.8, 1.6):
            for noise in (1e-4, 1e-2):
                K = _rbf(X, X, ls) + noise * np.eye(len(y_n))
                try:
                    L = np.linalg.cholesky(K)
                except np.linalg.LinAlgError:
                    continue
                alpha = np.linalg.solve(L.T, np.linalg.solve(L, y_n))
                ll = (
                    -0.5 * float(y_n @ alpha)
                    - float(np.sum(np.log(np.diag(L))))
                    - 0.5 * len(y_n) * np.log(2 * np.pi)
                )
                if best is None or ll > best[0]:
                    best = (ll, ls, noise, L, alpha)
        if best is None:
            return rng.random(d)
        _, ls, noise, L, alpha = best

        # candidate pool: fresh scrambled Sobol points + jitter around the
        # incumbent (local exploitation)
        cands = self._sobol_points(512, seed_offset=1 + trial_no)
        incumbent = X[int(np.argmax(y_n))]
        local = np.clip(
            incumbent[None, :] + 0.05 * rng.standard_normal((64, d)), 0.0, 1.0
        )
        cands = np.concatenate([cands, local], axis=0)

        Ks = _rbf(cands, X, ls)
        mu = Ks @ alpha
        v = np.linalg.solve(L, Ks.T)
        var = np.maximum(1.0 + noise - np.sum(v * v, axis=0), 1e-12)
        sigma = np.sqrt(var)
        y_best = float(np.max(y_n))
        xi = 0.01
        z = (mu - y_best - xi) / sigma
        ei = (mu - y_best - xi) * _norm_cdf(z) + sigma * _norm_pdf(z)
        return cands[int(np.argmax(ei))]


def _rbf(a: np.ndarray, b: np.ndarray, lengthscale: float) -> np.ndarray:
    d2 = (
        np.sum(a * a, axis=1)[:, None]
        + np.sum(b * b, axis=1)[None, :]
        - 2.0 * (a @ b.T)
    )
    return np.exp(-0.5 * np.maximum(d2, 0.0) / (lengthscale ** 2))


def _norm_cdf(x: np.ndarray) -> np.ndarray:
    from scipy.special import erf

    return 0.5 * (1.0 + erf(x / np.sqrt(2.0)))


def _norm_pdf(x: np.ndarray) -> np.ndarray:
    return np.exp(-0.5 * x * x) / np.sqrt(2.0 * np.pi)
