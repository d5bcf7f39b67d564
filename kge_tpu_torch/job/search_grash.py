"""GraSH multi-fidelity search: successive halving over epoch and/or
graph-size budgets (kge_tpu/job/search_grash.py; reference
kge/job/search_grash.py, after https://arxiv.org/abs/2207.04979,
implemented directly, without the HPBandster dependency: the scheduling
loop is a plain successive-halving recursion). Trials run in the search's
process, on its device.
"""

from __future__ import annotations

import copy
import math
import os
import shutil
from typing import Any, Dict, List, Optional

import numpy as np

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.job.job import Job
from kge_tpu_torch.job.search import (
    SearchJob, SearchSpace, init_trial_folder,
)
from kge_tpu_torch.utils.io import load_checkpoint, save_checkpoint
from kge_tpu_torch.utils.package import package_model
from kge_tpu_torch.utils.subgraph import KCoreManager


class GraSHSearchJob(SearchJob):
    def __init__(self, config, dataset, parent_job=None):
        super().__init__(config, dataset, parent_job)
        self.variant = self.config.check(
            "grash_search.variant", ["combined", "epoch", "graph"]
        )
        self.eta = self.config.get("grash_search.eta")
        self.num_trials_conf = self.config.get("grash_search.num_trials")
        self.search_budget = self.config.get("grash_search.search_budget")
        self.cost_metric = self.config.check(
            "grash_search.cost_metric", ["triples", "triples_and_entities"]
        )
        self.valid_frac = self.config.get("grash_search.valid_frac")
        self.valid_max = self.config.get("grash_search.valid_max")
        self.keep_initialization = self.config.get(
            "grash_search.keep_initialization"
        )
        self.keep_pretrained = self.config.get("grash_search.keep_pretrained")
        self.min_negatives_percentage = self.config.get(
            "grash_search.min_negatives_percentage"
        )
        self.seed = self.config.get("grash_search.seed")
        self.space = SearchSpace(self.config.get("grash_search.parameters"))

        num_rounds = round(math.log(self.num_trials_conf, self.eta))
        if self.eta ** num_rounds != self.num_trials_conf:
            raise ValueError(
                "grash_search.num_trials must be a positive integer power of "
                f"eta={self.eta} (got {self.num_trials_conf})"
            )
        self.num_rounds = num_rounds

        #: results of completed trials, keyed "round-trial" (the reference's
        #: trial_dict, search_grash.py:78-82,516-525) — lets the search resume
        self.trial_cache: Dict[str, float] = {}
        self._stored_trials: Optional[List[Dict[str, Any]]] = None

        if self.__class__ == GraSHSearchJob:
            for f in Job.job_created_hooks:
                f(self)

    # -- search-level checkpoint/resume ----------------------------------------

    def _save_search_state(self, trials):
        save_checkpoint(
            {
                "type": "search",
                "parameters": trials,
                "results": dict(self.trial_cache),
                "job_id": self.job_id,
                "config": self.config,
            },
            self.config.checkpoint_file(1),
        )

    def _load(self, checkpoint):
        if checkpoint["type"] != "search":
            raise ValueError("can only resume search checkpoints")
        self._stored_trials = checkpoint.get("parameters") or None
        self.trial_cache = dict(checkpoint.get("results") or {})
        self.resumed_from_job_id = checkpoint.get("job_id")

    # -- budget math (reference search_grash.py:364-416) -----------------------

    def _round_fidelities(self, round_idx: int, num_trials: int):
        """(epoch_fraction, graph_cost_budget) for a round: the per-trial
        budget in units of full training runs is (B / R) / num_trials; for
        "combined" it is split evenly (sqrt) between the two axes."""
        per_trial = self.search_budget / self.num_rounds / num_trials
        if self.variant == "epoch":
            return min(per_trial, 1.0), 1.0
        elif self.variant == "graph":
            return 1.0, min(per_trial, 1.0)
        else:
            split = math.sqrt(per_trial)
            return min(split, 1.0), min(split, 1.0)

    def _pick_subset(self, graph_budget: float) -> Optional[Dict]:
        """Largest subgraph with relative cost <= budget
        (reference search_grash.py:382-398); None = full graph."""
        if graph_budget >= 1.0:
            return None
        stats = self.kcore.decompose(
            self.valid_frac, self.valid_max,
            seed=0 if self.seed < 0 else self.seed,
        )
        best = None
        for s in stats:
            cost = s["relative_triples"]
            if self.cost_metric == "triples_and_entities":
                cost *= s["relative_entities"]
            if cost <= graph_budget:
                if best is None or s["relative_triples"] > best["relative_triples"]:
                    best = s
        if best is None and stats:
            # no subset fits: use the smallest one
            best = min(stats, key=lambda s: s["relative_triples"])
        return best

    # -- run -------------------------------------------------------------------

    def _run(self):
        rng = np.random.default_rng(None if self.seed < 0 else self.seed)
        metric_name = self.config.get("valid.metric")
        metric_max = self.config.get("valid.metric_max")
        self.kcore = KCoreManager(self.config, self.dataset)

        # generate the initial trial population (or reuse the checkpointed
        # one when resuming, so completed-trial cache keys stay valid)
        if self._stored_trials is not None:
            trials = self._stored_trials
        else:
            trials = [
                self.space.from_unit(
                    rng.random(max(self.space.num_tunable, 1))
                )
                for _ in range(self.num_trials_conf)
            ]
        trial_ids = list(range(len(trials)))
        max_epochs = self.config.get("train.max_epochs")
        self._save_search_state(trials)

        survivors = trial_ids
        results_by_round: List[Dict[int, float]] = []
        for round_idx in range(self.num_rounds):
            num_trials = len(survivors)
            epoch_frac, graph_budget = self._round_fidelities(
                round_idx, num_trials
            )
            epochs = max(1, int(round(epoch_frac * max_epochs)))
            subset = self._pick_subset(graph_budget)
            self.config.log(
                f"GraSH round {round_idx}: {num_trials} trials, "
                f"{epochs} epochs, subset="
                f"{subset['folder'] if subset else 'full graph'}"
            )

            round_results: Dict[int, float] = {}
            for trial_id in survivors:
                cache_key = f"{round_idx}-{trial_id}"
                if cache_key in self.trial_cache:
                    round_results[trial_id] = self.trial_cache[cache_key]
                    continue
                value = self._run_trial(
                    trial_id, trials[trial_id], round_idx, epochs, subset,
                    metric_name,
                )
                round_results[trial_id] = value
                self.trial_cache[cache_key] = value
                self._save_search_state(trials)
                self.config.trace(
                    event="search_completed", scope="train",
                    grash_round=round_idx, trial=trial_id,
                    metric_value=value, metric_name=metric_name,
                    echo=True, echo_prefix="  ", log=True,
                    **trials[trial_id],
                )
            results_by_round.append(round_results)

            # keep the best 1/eta trials
            keep = max(1, num_trials // self.eta)
            ordered = sorted(
                round_results.items(),
                key=lambda t: (t[1] if t[1] == t[1] else -math.inf),
                reverse=metric_max,
            )
            survivors = [t for t, _ in ordered[:keep]]

        best_trial = survivors[0]
        best_value = results_by_round[-1][best_trial]
        self.config.log(
            f"GraSH best trial {best_trial}: {metric_name}={best_value} "
            f"with {trials[best_trial]}"
        )
        self.trace(
            event="search_completed", scope="search",
            metric_value=best_value, metric_name=metric_name,
            best_parameters=trials[best_trial],
        )
        return {
            "best_parameters": trials[best_trial],
            "metric_value": best_value,
        }

    def _trial_folder_name(self, round_idx: int, trial_id: int) -> str:
        return f"round{round_idx}-trial{str(trial_id).zfill(5)}"

    def _run_trial(self, trial_id, parameters, round_idx, epochs, subset,
                   metric_name) -> float:
        folder = self._trial_folder_name(round_idx, trial_id)
        trial_config = self.config.clone(folder)
        trial_config.set("job.type", "train")
        trial_config.load_options(copy.deepcopy(parameters), create=True)
        trial_config.set("train.max_epochs", int(epochs))
        trial_config.set("valid.every", int(epochs))

        os.makedirs(trial_config.folder, exist_ok=True)

        predecessor_folder = None
        if round_idx > 0:
            predecessor_folder = os.path.join(
                os.path.dirname(trial_config.folder),
                self._trial_folder_name(round_idx - 1, trial_id),
            )

        # full-graph trials share the search's in-memory dataset (it may
        # live outside the data roots, e.g. a test fixture)
        dataset = self.dataset.shallow_copy()
        if subset is not None:
            trial_config.set("dataset.name", os.path.basename(subset["folder"]))
            # scale negatives by the relative entity count
            # (reference search_grash.py:400-416)
            scale = max(
                subset["relative_entities"], self.min_negatives_percentage
            )
            for slot in ("s", "o"):
                key = f"negative_sampling.num_samples.{slot}"
                try:
                    num = trial_config.get(key)
                except KeyError:
                    continue
                if num > 0:
                    trial_config.set(key, max(1, int(round(num * scale))))
            dataset = Dataset.create(
                trial_config, folder=subset["folder"]
            )
        if self.keep_initialization:
            trial_config.set("random_seed.default", 17 + trial_id)

        # carry state from the predecessor round (reference
        # search_grash.py:419-469): graph-growing variants initialize
        # embeddings from the predecessor's packaged model (rows matched by
        # external id, so growing vocabularies work); the epoch variant
        # resumes the predecessor's checkpoint outright
        resume_checkpoint = None
        if predecessor_folder is not None and self.variant != "epoch":
            pretrain_file = None
            if self.keep_pretrained:
                pretrain_file = os.path.join(predecessor_folder, "model_best.pt")
            elif self.keep_initialization:
                pretrain_file = os.path.join(
                    predecessor_folder, "model_00000.pt"
                )
            if pretrain_file is not None and os.path.isfile(pretrain_file):
                trial_config.set(
                    "lookup_embedder.pretrain.model_filename", pretrain_file
                )
        elif predecessor_folder is not None and self.variant == "epoch":
            pred_config = Config(folder=predecessor_folder)
            last = pred_config.last_checkpoint_number()
            if last is not None:
                src = pred_config.checkpoint_file(last)
                dst = trial_config.checkpoint_file(last)
                shutil.copy(src, dst)
                resume_checkpoint = dst
                trial_config.log(
                    f"Copied predecessor checkpoint {src}; resuming."
                )

        init_trial_folder(trial_config)

        try:
            if resume_checkpoint is not None:
                checkpoint = load_checkpoint(resume_checkpoint)
                job = Job.create_from(
                    checkpoint, new_config=trial_config, dataset=dataset
                )
            else:
                job = Job.create(trial_config, dataset=dataset)
            job.parent_job = self
            trial_config.log(
                f"GraSH trial {trial_id} runs on {job.device} in process "
                f"{os.getpid()}"
            )
            job.run()
            valid_trace = getattr(job, "valid_trace", [])
            self._package_trial_model(trial_config, job.dataset)
            if not valid_trace:
                return float("nan")
            return float(valid_trace[-1].get(metric_name, float("nan")))
        except BaseException as e:
            self.config.log(f"GraSH trial {trial_id} failed: {e!r}")
            if self.on_error == "continue":
                return float("nan")
            raise

    def _package_trial_model(self, trial_config: Config, dataset: Dataset):
        """Package the trial's init/best checkpoint so the next round can
        initialize from it (reference search_grash.py:482-490)."""
        if self.variant == "epoch":
            return
        jobs = []
        if self.keep_initialization:
            jobs.append(("checkpoint_00000.pt", "model_00000.pt"))
        if self.keep_pretrained:
            jobs.append(("checkpoint_best.pt", "model_best.pt"))
        for src, dst in jobs:
            src_path = os.path.join(trial_config.folder, src)
            if os.path.isfile(src_path):
                package_model(
                    src_path, os.path.join(trial_config.folder, dst),
                    dataset=dataset,
                )
