"""Dump commands: export traces as CSV, checkpoints and configs as YAML
(kge_tpu/utils/dump.py; reference kge/util/dump.py, simplified to the
load-bearing surface). Either package prints the same text for the same
folder, checkpoint or file."""

from __future__ import annotations

import csv
import math
import os
import sys
from typing import Any, Dict, List, Optional

import yaml

from kge_tpu_torch.config import Config


def add_dump_parsers(subparsers):
    parser = subparsers.add_parser(
        "dump", help="Dump objects to stdout"
    )
    dump_subparsers = parser.add_subparsers(title="dump_command", dest="dump_command")
    dump_subparsers.required = True

    trace_parser = dump_subparsers.add_parser(
        "trace", help="Dump trace entries as CSV (default) or YAML"
    )
    trace_parser.add_argument(
        "source", nargs="?", default=".",
        help="trace file, job folder, or checkpoint",
    )
    trace_parser.add_argument("--train", action="store_true",
                              help="include training epochs")
    trace_parser.add_argument("--valid", action="store_true",
                              help="include validation epochs")
    trace_parser.add_argument("--test", action="store_true",
                              help="include test evaluations")
    trace_parser.add_argument("--search", action="store_true",
                              help="dump the best result of every search trial")
    trace_parser.add_argument("--keysfile", type=str, default=None,
                              help="file with 'new_key=key' lines to add as "
                                   "columns (trace first, config second; "
                                   "special keys: $folder, $checkpoint, "
                                   "$machine, $base_model)")
    trace_parser.add_argument("--keys", "-k", nargs="*", default=[],
                              help="additional 'new_key=key' or 'key' columns")
    trace_parser.add_argument("--yaml", action="store_true",
                              help="dump raw yaml instead of CSV")
    trace_parser.add_argument("--checkpoint", action="store_true",
                              help="determine the starting job_id from the "
                                   "folder's best-or-last checkpoint")
    trace_parser.add_argument("--job_id", default=None,
                              help="training job id from which the trace is "
                                   "processed backwards (default: last)")
    trace_parser.add_argument("--truncate", nargs="?", const=True,
                              default=False,
                              help="maximum epoch to include; without an "
                                   "argument, uses the checkpoint's epoch")
    trace_parser.add_argument("--batch", action="store_true",
                              help="include batch-scoped entries")
    trace_parser.add_argument("--example", action="store_true",
                              help="include example-scoped entries")
    trace_parser.add_argument("--no-header", action="store_true",
                              help="omit the CSV header row")
    trace_parser.add_argument("--no-default-keys", "-K", action="store_true",
                              help="exclude the default columns")
    trace_parser.add_argument("--list-keys", action="store_true",
                              help="list all keys occurring in the selected "
                                   "entries and exit")

    checkpoint_parser = dump_subparsers.add_parser(
        "checkpoint", help="Dump a checkpoint overview as YAML"
    )
    checkpoint_parser.add_argument("source", help="checkpoint file or job folder")
    checkpoint_parser.add_argument("--keys", "-k", nargs="*", default=[])

    config_parser = dump_subparsers.add_parser(
        "config", help="Dump a configuration"
    )
    config_parser.add_argument("source", help="config file, folder, or checkpoint")
    config_parser.add_argument(
        "--minimal", action="store_true",
        help="only dump options that differ from the defaults",
    )
    config_parser.add_argument(
        "--raw", action="store_true", help="dump the stored file unmodified"
    )


def dump(args):
    if args.dump_command == "trace":
        _dump_trace(args)
    elif args.dump_command == "checkpoint":
        _dump_checkpoint(args)
    elif args.dump_command == "config":
        _dump_config(args)
    else:
        raise ValueError(f"unknown dump command {args.dump_command}")


def _resolve_trace_file(source: str) -> str:
    if os.path.isdir(source):
        return os.path.join(source, "trace.yaml")
    return source


def _read_trace(path: str) -> List[Dict[str, Any]]:
    entries = []
    with open(path, "r") as f:
        for line in f:
            line = line.strip()
            if line:
                entries.append(yaml.safe_load(line))
    return entries


_DEFAULT_TRACE_COLUMNS = [
    "job", "job_id", "type", "scope", "epoch", "split", "event",
    "avg_loss", "avg_cost", "epoch_time",
    "mean_reciprocal_rank_filtered", "mean_reciprocal_rank_filtered_with_test",
    "mean_reciprocal_rank", "hits_at_1_filtered", "hits_at_3_filtered",
    "hits_at_10_filtered", "mean_rank_filtered",
]


def _dump_trace(args):
    """Reference kge/util/dump.py:279-591 (surface; own implementation)."""
    source = args.source
    folder = source if os.path.isdir(source) else os.path.dirname(source) or "."
    checkpoint_path = None
    job_id = args.job_id
    truncate_epoch: Optional[int] = None
    if args.truncate not in (False, True):
        truncate_epoch = int(args.truncate)
    if os.path.isfile(source) and source.endswith(".pt"):
        checkpoint_path = source
    elif getattr(args, "checkpoint", False) and os.path.isdir(source):
        checkpoint_path = Config.best_or_last_checkpoint_file(source)
    if checkpoint_path is not None:
        from kge_tpu_torch.utils.io import load_checkpoint

        checkpoint = load_checkpoint(checkpoint_path)
        job_id = job_id or checkpoint.get("job_id")
        if args.truncate is True:
            truncate_epoch = checkpoint.get("epoch")
    elif args.truncate is True:
        raise ValueError(
            "--truncate without an epoch number requires a checkpoint "
            "(a checkpoint source or --checkpoint)"
        )
    path = _resolve_trace_file(
        folder if os.path.isdir(source) or checkpoint_path else source
    )
    entries = _read_trace(path)

    if args.search:
        selected = _best_search_trial_entries(entries)
    else:
        selected = _select_training_entries(
            entries, args, job_id, truncate_epoch
        )

    if args.list_keys:
        keys: Dict[str, None] = {}
        for e in selected:
            for k in e:
                keys.setdefault(k, None)
        for k in keys:
            print(k)
        return

    if args.yaml:
        for e in selected:
            print(yaml.dump(e, default_flow_style=True, width=float("inf")).strip())
        return

    # column spec: 'name=key' renames; bare 'key' keeps its name. Values are
    # resolved from the trace entry first and the job folder's config second;
    # $-keys are derived.
    extra_specs: List[str] = list(args.keys)
    if args.keysfile:
        with open(args.keysfile) as f:
            extra_specs += [
                line.strip() for line in f
                if line.strip() and not line.strip().startswith("#")
            ]
    extra: List[tuple] = []
    for spec in extra_specs:
        name, _, key = spec.partition("=")
        extra.append((name.strip(), (key or name).strip()))

    default_columns = [] if args.no_default_keys else [
        c for c in _DEFAULT_TRACE_COLUMNS
        if any(c in e for e in selected)
    ]
    config_cache: Dict[str, Optional[Config]] = {}

    def lookup(entry, key):
        if key == "$folder":
            return entry.get("folder", folder)
        if key == "$checkpoint":
            return checkpoint_path or ""
        if key == "$machine":
            import platform

            return platform.node()
        if key == "$base_model":
            model = _config_value(entry, "model", folder, config_cache)
            if model == "reciprocal_relations_model":
                return _config_value(
                    entry, "reciprocal_relations_model.base_model.type",
                    folder, config_cache,
                )
            return model
        if key in entry:
            return entry[key]
        return _config_value(entry, key, folder, config_cache)

    writer = csv.writer(sys.stdout)
    if not args.no_header:
        writer.writerow(default_columns + [name for name, _ in extra])
    for e in selected:
        row = [e.get(c, "") for c in default_columns]
        row += [lookup(e, key) for _, key in extra]
        writer.writerow(row)


def _select_training_entries(entries, args, job_id, truncate_epoch):
    any_filter = args.train or args.valid or args.test
    train = args.train or not any_filter
    valid = args.valid or not any_filter
    test = args.test
    scopes = ["epoch"]
    if args.batch:
        scopes.append("batch")
    if args.example:
        scopes.append("example")

    # lineage walk (resumed jobs form one logical run), as in
    # Trace.grep_training_trace_entries but with configurable scopes
    from kge_tpu_torch.job.trace import Trace

    trace = Trace()
    trace.entries = entries
    lineage = Trace.grep_training_trace_entries(
        tracefile=None, train=True, valid=True, test=True, job_id=job_id,
        _preloaded=trace,
    )
    lineage_ids = {e.get("job_id") for e in lineage} | {
        e.get("parent_job_id") for e in lineage
    }
    if not lineage_ids:
        lineage_ids = {e.get("job_id") for e in entries}

    selected = []
    for e in entries:
        if e.get("scope", "epoch") not in scopes:
            continue
        jid = e.get("job_id")
        pid = e.get("parent_job_id")
        if jid not in lineage_ids and pid not in lineage_ids and not any(
            isinstance(i, str) and isinstance(pid, str) and i.startswith(pid)
            for i in lineage_ids
        ):
            continue
        if truncate_epoch is not None and e.get("epoch", 0) > truncate_epoch:
            continue
        job = e.get("job")
        if job == "train":
            if train and (
                e.get("event") in ("epoch_completed", None)
                or e.get("scope") in ("batch", "example")
            ):
                selected.append(e)
        elif job == "eval":
            split = e.get("split")
            if (split == "valid" and valid) or (split == "test" and test):
                selected.append(e)
    return selected


def _best_search_trial_entries(entries):
    """The final validation result of every search trial (entries annotated
    by the search job with folder/metric_value, reference search.py:107-232).

    The last entry per trial is kept: the search job already records the
    trial's best according to valid.metric / valid.metric_max, so picking a
    numeric max here would invert lower-is-better metrics (e.g. mean_rank)
    when a resumed search re-reports a trial."""
    last: Dict[str, Dict[str, Any]] = {}
    order: List[str] = []
    for e in entries:
        if e.get("job") == "search" and e.get("scope") == "train":
            trial = str(e.get("folder", e.get("child_job_id", "")))
            if trial not in last:
                order.append(trial)
            if e.get("metric_value") is not None or trial not in last:
                last[trial] = e
    return [last[t] for t in order if t in last]


def _config_value(entry, key, folder, cache):
    """Resolve a dotted config key for the job folder the entry came from
    (search-trial entries carry their own subfolder)."""
    sub = entry.get("folder")
    candidates = []
    if isinstance(sub, str):
        candidates.append(sub if os.path.isabs(sub) else os.path.join(folder, sub))
    candidates.append(folder)
    for cand in candidates:
        if cand not in cache:
            cfg_path = os.path.join(cand, "config.yaml")
            cfg = None
            if os.path.isfile(cfg_path):
                try:
                    cfg = Config(folder=cand, load_default=True)
                    with open(cfg_path) as f:
                        cfg.load_options(yaml.safe_load(f), create=True)
                except Exception:
                    cfg = None
            cache[cand] = cfg
        cfg = cache[cand]
        if cfg is not None:
            try:
                return cfg.get(key)
            except KeyError:
                continue
    return ""


def _leaves(tree, path=()):
    """(path, leaf) pairs of a parameter tree in JAX's pytree order: dict
    keys sorted, lists and tuples in order, None no leaf."""
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _leaves(tree[key], path + (key,))
    elif isinstance(tree, (list, tuple)):
        for i, item in enumerate(tree):
            yield from _leaves(item, path + (i,))
    elif tree is not None:
        yield path, tree


def _dump_checkpoint(args):
    from kge_tpu_torch.ops.optim import parameter_name
    from kge_tpu_torch.utils.io import load_checkpoint

    source = args.source
    if os.path.isdir(source):
        source = Config.best_or_last_checkpoint_file(source)
    checkpoint = load_checkpoint(source)
    overview: Dict[str, Any] = {
        "file": source,
        "type": checkpoint.get("type"),
        "epoch": checkpoint.get("epoch"),
        "job_id": checkpoint.get("job_id"),
    }
    if "model" in checkpoint and checkpoint["model"] is not None:
        # leaves are numpy arrays, or bfloat16 tensors (utils/io.py)
        leaves = list(_leaves(checkpoint["model"][0]))
        names = [parameter_name(path) for path, _ in leaves]
        overview["parameter_names"] = names
        overview["parameter_shapes"] = {
            n: [int(s) for s in l.shape] for n, (_, l) in zip(names, leaves)
        }
        overview["num_parameters"] = int(
            sum(math.prod(l.shape) for _, l in leaves)
        )
    if "valid_trace" in checkpoint and checkpoint["valid_trace"]:
        last = checkpoint["valid_trace"][-1]
        overview["last_valid_epoch"] = last.get("epoch")
        overview["last_valid_metrics"] = {
            k: v for k, v in last.items()
            if isinstance(v, float) and ("rank" in k or "hits" in k)
        }
    if "config" in checkpoint and checkpoint["config"] is not None:
        cfg = checkpoint["config"]
        overview["model"] = cfg.options.get("model")
        overview["dataset"] = cfg.options.get("dataset", {}).get("name")
    if args.keys:
        for k in args.keys:
            overview[k] = checkpoint.get(k)
    print(yaml.dump(overview, default_flow_style=False))


def _dump_config(args):
    # options name kge_tpu's modules, as the files both packages read do
    # (Config._shared_options)
    source = args.source
    if os.path.isdir(source):
        source = os.path.join(source, "config.yaml")
    if source.endswith(".pt"):
        from kge_tpu_torch.utils.io import load_checkpoint

        checkpoint = load_checkpoint(source)
        options = checkpoint["config"]._shared_options()
    else:
        with open(source) as f:
            options = yaml.safe_load(f)
    if args.raw:
        print(yaml.dump(options, default_flow_style=False))
        return
    if args.minimal:
        default = Config()._shared_options()
        flat_default = Config.flatten(default)
        flat = Config.flatten(options)
        minimal: Dict[str, Any] = {}
        for k, v in flat.items():
            if "+++" in k or v == "+++":
                continue
            if flat_default.get(k, "__missing__") != v:
                minimal[k] = v
        print(yaml.dump(minimal, default_flow_style=False))
        return
    # full: defaults overlaid with the stored options
    config = Config()
    config.load_options(options, create=True)
    print(yaml.dump(config._shared_options(), default_flow_style=False))
