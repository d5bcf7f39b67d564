"""kge_tpu_torch command-line interface.

Verbs, with kge_tpu's surface (kge_tpu/cli.py; the reference's
kge/cli.py:87-138): ``start`` / ``create`` build a new experiment from a
config file, ``resume`` continues one, and ``eval`` / ``valid`` / ``test``
are evaluation presets over resume. Folders and checkpoints written by
kge_tpu or by this package serve alike. Any configuration key can be passed
as ``--dotted.key value`` (or ``--dotted.key=value``) and is validated by
the typed ``Config.set``. ``dump`` inspects traces, checkpoints and
configs, and ``package`` exports a standalone model file. Jobs run on the
CUDA card unless ``--job.device cpu`` is given.
"""

from __future__ import annotations

import argparse
import datetime
import os
import sys
import traceback
from typing import Dict, List, Tuple

import yaml

from kge_tpu_torch import Config, Dataset
from kge_tpu_torch.misc import kge_base_dir
from kge_tpu_torch.utils.dump import add_dump_parsers, dump
from kge_tpu_torch.utils.io import get_checkpoint_file, load_checkpoint
from kge_tpu_torch.utils.package import add_package_parser, package_model
from kge_tpu_torch.utils.seed import apply_device_config, seed_from_config

_TRUE_WORDS = frozenset(("yes", "true", "t", "y", "1"))
_FALSE_WORDS = frozenset(("no", "false", "f", "n", "0"))

#: short aliases for frequently-used configuration keys
_SHORT_KEYS = (
    ("-d", "dataset.name"),
    ("-j", "job.type"),
    ("-e", "train.max_epochs"),
    ("-m", "model"),
)

#: verbs that are presets over a base verb; the preset key/value pairs are
#: forced: an explicit conflicting override is rejected
_EVAL_PRESETS = {
    "eval": {"job.type": "eval"},
    "valid": {"job.type": "eval", "eval.split": "valid"},
    "test": {"job.type": "eval", "eval.split": "test"},
}


def argparse_bool_type(text):
    """Parse common yes/no spellings into a bool."""
    if isinstance(text, bool):
        return text
    word = str(text).lower()
    if word in _TRUE_WORDS:
        return True
    if word in _FALSE_WORDS:
        return False
    raise argparse.ArgumentTypeError(f"not a boolean: {text!r}")


def build_parser() -> argparse.ArgumentParser:
    shared = argparse.ArgumentParser(add_help=False)
    for short, key in _SHORT_KEYS:
        shared.add_argument("--" + key, short, metavar="VALUE")
    shared.add_argument(
        "--abort-when-cache-outdated", action="store_true",
        help="fail when a stale cached dataset file is found instead of "
        "recomputing it",
    )
    parser = argparse.ArgumentParser(
        "kge_tpu_torch",
        epilog="Any configuration key can be set with --<dotted.key> <value>.",
    )
    verbs = parser.add_subparsers(title="command", dest="command", required=True)
    for verb, blurb in (
        ("start", "Create a new job and run it"),
        ("create", "Create a new job without running it"),
    ):
        sub = verbs.add_parser(verb, help=blurb, parents=[shared])
        sub.add_argument("config", nargs="?", help="config yaml file")
        sub.add_argument("--folder", "-f", help="experiment folder to create")
        sub.add_argument(
            "--run", type=argparse_bool_type, default=(verb == "start"),
            help="run the job after creating it",
        )
    for verb, blurb in (
        ("resume", "Resume a prior job"),
        ("eval", "Evaluate the result of a prior job"),
        ("valid", "Evaluate a prior job on validation data"),
        ("test", "Evaluate a prior job on test data"),
    ):
        sub = verbs.add_parser(verb, help=blurb, parents=[shared])
        sub.add_argument("config", help="experiment folder or its config.yaml")
        sub.add_argument(
            "--checkpoint", default="default",
            help="'default', 'last', 'best', an epoch number, or a file name",
        )
    add_dump_parsers(verbs)
    add_package_parser(verbs)
    return parser


def collect_overrides(tokens: List[str]) -> List[Tuple[str, str]]:
    """Turn leftover ``--key value`` / ``--key=value`` tokens into ordered
    (key, raw-value) pairs."""
    pairs: List[Tuple[str, str]] = []
    i = 0
    while i < len(tokens):
        token = tokens[i]
        if not token.startswith("--"):
            raise SystemExit(f"kge_tpu_torch: unrecognized argument: {token}")
        name = token[2:]
        if "=" in name:
            name, raw = name.split("=", 1)
            i += 1
        elif i + 1 < len(tokens) and not tokens[i + 1].startswith("--"):
            raw = tokens[i + 1]
            i += 2
        else:
            raise SystemExit(f"kge_tpu_torch: missing value for --{name}")
        pairs.append((name, raw))
    return pairs


def apply_overrides(config: Config, pairs: List[Tuple[str, str]],
                    forced: Dict[str, str] = {}) -> None:
    """Apply (key, value) overrides to ``config``: bools accept yes/no
    spellings, lists/dicts parse as yaml, numbers are coerced by
    ``Config.set``; ``forced`` entries (from the preset verbs) are applied
    last and may not be contradicted by an explicit override."""
    for key, value in pairs:
        if key in forced and str(value) != str(forced[key]):
            raise ValueError(
                f"--{key} {value} conflicts with this command "
                f"(which implies {key}={forced[key]})"
            )
        if key == "search.device_pool" and isinstance(value, str):
            value = value.split(",")
        try:
            entry = config.get(key)
        except KeyError:
            entry = None
        if isinstance(entry, bool):
            value = argparse_bool_type(value)
        elif isinstance(entry, (list, dict)) and isinstance(value, str):
            value = yaml.safe_load(value)
        config.set(key, value)
        if key == "model":
            config._import(value)
    for key, value in forced.items():
        config.set(key, value)


def _fresh_experiment_folder(config_path: str) -> str:
    stem = os.path.splitext(os.path.basename(config_path))[0]
    stamp = datetime.datetime.now().strftime("%Y%m%d-%H%M%S")
    return os.path.join(os.getcwd(), "local", "experiments", f"{stamp}-{stem}")


def main(argv=None):
    from kge_tpu_torch.job import Job

    parser = build_parser()
    args, leftover = parser.parse_known_args(argv)
    command = args.command
    if command == "dump":
        if leftover:
            parser.parse_args(argv)  # reject the unknown arguments with usage
        dump(args)
        return
    if command == "package":
        if leftover:
            parser.parse_args(argv)
        package_model(args.checkpoint, args.file)
        return

    overrides = collect_overrides(leftover)
    # the four short/long aliases argparse knows about join the override list
    for _, key in _SHORT_KEYS:
        value = vars(args).get(key)
        if value is not None:
            overrides.append((key, value))
    forced = _EVAL_PRESETS.get(command, {})
    if command in _EVAL_PRESETS:
        command = "resume"
    run_job = command == "resume" or (command in ("start", "create") and args.run)
    if command == "create":
        command = "start"

    config = Config()
    quiet = any(k == "console.quiet" and argparse_bool_type(v)
                for k, v in overrides)

    if command == "start":
        if args.config is None:
            args.config = os.path.join(
                kge_base_dir(), "..", "examples", "toy-complex-train.yaml"
            )
            print(
                "WARNING: No configuration specified; using " + args.config,
                file=sys.stderr,
            )
        if not quiet:
            print(f"Loading configuration {args.config}...")
        config.load(args.config)
    else:  # resume family
        target = args.config
        if os.path.isdir(target) and os.path.isfile(
            os.path.join(target, "config.yaml")
        ):
            target = os.path.join(target, "config.yaml")
        if not quiet:
            print(f"Resuming from configuration {target}...")
        config.load(target)
        config.folder = os.path.dirname(target) or "."
        if not os.path.exists(config.folder):
            raise ValueError(f"{target} is not a valid config file for resuming")

    apply_overrides(config, overrides, forced)

    if command == "start":
        config.folder = args.folder or _fresh_experiment_folder(args.config)

    try:
        # the ranks of a run over several processes come up before anything
        # touches the card or seeds (kge_tpu/cli.py); rank 0 alone creates
        # the folder, which the others write their checkpoint shards into
        from kge_tpu_torch.parallel import distributed

        distributed.maybe_initialize(config)
        if command == "start" and not config.init_folder():
            raise ValueError(f"output folder {config.folder} exists already")
        distributed.barrier("init_folder")
        config.log(f"Using folder: {config.folder}")

        checkpoint_file = None
        if command == "resume":
            checkpoint_file = get_checkpoint_file(config, args.checkpoint)
            if checkpoint_file is None and forced:
                raise ValueError(f"no checkpoint found in {config.folder}")

        Dataset._abort_when_cache_outdated = args.abort_when_cache_outdated
        apply_device_config(config)
        seed_from_config(config)

        if not run_job:
            config.log("Job created successfully.")
            return

        dataset = Dataset.create(config)
        if command == "resume" and checkpoint_file is not None:
            # a rank of a model axis reads its rows of a sharded checkpoint
            from kge_tpu_torch.parallel.mesh import entity_shard

            shard = entity_shard(config, dataset.num_entities())
            checkpoint = load_checkpoint(
                checkpoint_file, rows=None if shard is None else shard[:2])
            job = Job.create_from(checkpoint, new_config=config, dataset=dataset)
        else:
            job = Job.create(config, dataset)
            if command == "resume":
                job.config.log(
                    "No checkpoint found or specified, starting from scratch..."
                )
        config.log("Configuration:")
        config.log(yaml.dump(config.options, default_flow_style=False),
                   prefix="  ", echo=False)
        job.run()
        # every rank ends here after the job's last collective
        distributed.shutdown()
    except BaseException:
        config.log(traceback.format_exc(), echo=False)
        raise


if __name__ == "__main__":
    main()
