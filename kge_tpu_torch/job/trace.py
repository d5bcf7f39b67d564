"""Trace-file analysis and console rendering of trace entries
(kge_tpu/job/trace.py; reference kge/job/trace.py).

``Trace`` parses the one-line-yaml ``trace.yaml`` records of a job folder,
filters them by key, converts them to pandas (imported on call only), and
reconstructs resumed-job lineages (a training job resumed several times
forms one logical training run).
"""

from __future__ import annotations

import re
from typing import Any, Dict, List, Optional

import yaml


class Trace:
    """In-memory representation of a trace file."""

    def __init__(self, tracefile: Optional[str] = None, regex_filter=None):
        self.entries: List[Dict[str, Any]] = []
        if tracefile:
            self.load(tracefile, regex_filter)

    def load(self, tracefile: str, regex_filter=None):
        pattern = re.compile(regex_filter) if regex_filter else None
        with open(tracefile, "r") as f:
            for line in f:
                if pattern and not pattern.search(line):
                    continue
                line = line.strip()
                if line:
                    self.entries.append(yaml.safe_load(line))

    def filter(self, filter_dict: Dict[str, Any] = {}) -> List[Dict[str, Any]]:
        def predicate(entry):
            for key, value in filter_dict.items():
                if entry.get(key) != value:
                    return False
            return True

        return [e for e in self.entries if predicate(e)]

    def to_dataframe(self, filter_dict: Dict[str, Any] = {}):
        import pandas as pd

        return pd.DataFrame(self.filter(filter_dict))

    @staticmethod
    def grep_training_trace_entries(
        tracefile: Optional[str],
        train: bool = True,
        valid: bool = True,
        test: bool = False,
        batch_info: bool = False,
        job_id: Optional[str] = None,
        _preloaded: Optional["Trace"] = None,
    ):
        """Epoch-scoped train/eval entries of the (lineage of) a training
        job. When ``job_id`` is given, follows resumed_from links backwards
        to include all predecessor jobs' entries up to their resume epochs
        (reference trace.py:109-236)."""
        trace = _preloaded if _preloaded is not None else Trace(tracefile)
        entries = [
            e for e in trace.entries
            if e.get("scope") in (("epoch", "batch") if batch_info else ("epoch",))
        ]

        # resolve lineage: job_id -> resumed_from_job_id (short prefixes)
        resumed_from: Dict[str, Optional[str]] = {}
        resume_epoch: Dict[str, int] = {}
        for e in trace.entries:
            jid = e.get("job_id")
            if jid and e.get("event") == "job_resumed":
                resumed_from[jid] = e.get("resumed_from_job_id")
                resume_epoch[jid] = e.get("epoch", 0)

        if job_id is None:
            # use the last training job in the file
            train_jobs = [
                e.get("job_id") for e in entries if e.get("job") == "train"
            ]
            if not train_jobs:
                return []
            job_id = train_jobs[-1]

        # lineage chain with epoch cutoffs
        chain: List[tuple] = []
        current: Optional[str] = job_id
        cutoff = float("inf")
        while current is not None:
            chain.append((current, cutoff))
            prev = resumed_from.get(current)
            if prev is not None:
                cutoff = resume_epoch.get(current, 0)
                # short prefix -> find full id
                matches = {
                    e.get("job_id") for e in trace.entries
                    if e.get("job_id", "").startswith(prev)
                }
                current = next(iter(matches), None) if matches else None
            else:
                current = None

        allowed = {jid: cut for jid, cut in chain}

        def keep(e):
            jid = e.get("job_id")
            # validation entries carry the parent training job id
            pid_short = e.get("parent_job_id")
            for known, cut in allowed.items():
                if jid == known or (pid_short and known.startswith(pid_short)):
                    if e.get("epoch", 0) <= cut:
                        job = e.get("job")
                        if job == "train":
                            return train
                        if job == "eval":
                            return (
                                valid if e.get("split") == "valid" else test
                            )
            return False

        return [e for e in entries if keep(e)]



def format_trace_entry(format_key: str, trace_entry: Dict[str, Any], config) -> str:
    """The ``console.format.<format_key>`` expression — a Python expression
    with access to ``trace``, ``config`` and every entry key — evaluated over
    the entry, or the full yaml dump when no expression is configured."""
    try:
        expr = config.get("console.format." + format_key)
    except KeyError:
        expr = ""
    if expr:
        return eval(
            expr,
            dict(yaml=yaml),
            dict(config=config, trace=trace_entry, **trace_entry),
        )
    return yaml.dump(trace_entry, default_flow_style=False)
