"""Yaml-driven configuration system.

A fresh implementation of the configuration semantics of the reference
(kge/config.py): nested-dict options with dotted-key access, typed ``set`` with
string coercion, type-hierarchy default lookup (``get_default``), module yaml
imports, ``+++`` extensible keys, experiment-folder management, and structured
logging/tracing (``kge.log`` / ``trace.yaml``).
"""

from __future__ import annotations

import copy
import datetime
import os
import time
import uuid
from enum import Enum
from typing import Any, Dict, List, Optional, Union

import yaml


from kge_tpu_torch import misc


def _is_primary_process() -> bool:
    """True unless this is a rank other than 0 of a run over several
    processes (parallel/distributed.py): only rank 0 owns the experiment
    folder, its log, trace and config, and the console, as in kge_tpu
    (kge_tpu/config.py ``_is_primary_process``)."""
    import sys

    dist = sys.modules.get("torch.distributed")
    if dist is None or not dist.is_available() or not dist.is_initialized():
        return True
    return dist.get_rank() == 0


class _Trace:
    """Cheap single-line-yaml trace writer (see Config.trace)."""


class Config:
    """Configuration options of a job.

    All options are stored in a nested dict ``self.options`` and are accessed
    with dotted keys (e.g. ``train.optimizer.default.type``).
    """

    Overwrite = Enum("Overwrite", "Yes No Error DefaultOnly")

    def __init__(self, folder: Optional[str] = None, load_default: bool = True):
        if load_default:
            with open(
                os.path.join(os.path.dirname(__file__), "config-default.yaml"), "r"
            ) as f:
                self.options: Dict[str, Any] = yaml.safe_load(f)
        else:
            self.options = {}
        self.folder = folder  # main folder (config file, checkpoints, ...)
        self.log_folder: Optional[str] = None  # alternative folder for logs/traces
        self.log_prefix: Optional[str] = None

    # -- ACCESS ---------------------------------------------------------------

    def get(self, key: str, remove_plusplusplus: bool = True) -> Any:
        """Obtain value of specified dotted key."""
        result = self.options
        for name in key.split("."):
            try:
                result = result[name]
            except (KeyError, TypeError):
                raise KeyError(f"Error accessing {name} for key {key}")

        if remove_plusplusplus and isinstance(result, dict):

            def do_remove_plusplusplus(option):
                if isinstance(option, dict):
                    option.pop("+++", None)
                    for values in option.values():
                        do_remove_plusplusplus(values)

            result = copy.deepcopy(result)
            do_remove_plusplusplus(result)

        return result

    def exists(self, key: str, remove_plusplusplus: bool = True) -> bool:
        try:
            self.get(key, remove_plusplusplus)
            return True
        except KeyError:
            return False

    def get_default(self, key: str) -> Any:
        """Like ``get``, but if ``key`` is not present, walk the type hierarchy.

        When a prefix ``a.b`` of the key has a sibling option ``a.b.type`` set
        to ``T``, the remainder of the key is looked up under ``T`` instead
        (recursively). This is how e.g. ``complex.entity_embedder.dropout``
        falls back to ``lookup_embedder.dropout`` (reference kge/config.py:92).
        """
        try:
            return self.get(key)
        except KeyError as e:
            last_dot_index = key.rfind(".")
            if last_dot_index < 0:
                raise e
            parent = key[:last_dot_index]
            field = key[last_dot_index + 1 :]
            # iteratively: if parent has a `type`, restart the lookup under
            # that type name; otherwise move one level up the key path
            for _ in range(1000):  # guards against type cycles
                try:
                    parent_type = self.get(parent + "." + "type")
                    new_key = parent_type + "." + field
                    last_dot_index = new_key.rfind(".")
                    parent = new_key[:last_dot_index]
                    field = new_key[last_dot_index + 1 :]
                except KeyError:
                    last_dot_index = parent.rfind(".")
                    if last_dot_index < 0:
                        raise e
                    field = parent[last_dot_index + 1 :] + "." + field
                    parent = parent[:last_dot_index]
                    continue
                try:
                    return self.get(parent + "." + field)
                except KeyError:
                    continue
            raise KeyError(f"type-hierarchy lookup for {key} did not terminate")

    def get_first_present_key(self, *keys: str, use_get_default: bool = False) -> str:
        for key in keys:
            if use_get_default:
                try:
                    self.get_default(key)
                    return key
                except KeyError:
                    pass
            elif self.exists(key):
                return key
        raise KeyError(f"none of the following keys found: {keys}")

    def get_first(self, *keys: str, use_get_default: bool = False) -> Any:
        if use_get_default:
            return self.get_default(
                self.get_first_present_key(*keys, use_get_default=True)
            )
        else:
            return self.get(self.get_first_present_key(*keys))

    # -- MODIFICATION ---------------------------------------------------------

    @staticmethod
    def _coerce(value: Any, template: Any) -> Any:
        """Nudge ``value`` toward the type of the entry it will replace.

        Strings parse to ints/floats (guided by ``template`` when one
        exists, by their own shape otherwise), ints widen to floats, and
        bools stringify when the entry holds a string. Values that cannot
        be reconciled are returned unchanged — the caller decides whether a
        leftover mismatch is an error.
        """
        from kge_tpu_torch.misc import is_number

        if template is None:
            if isinstance(value, str):
                for numeric in (int, float):
                    if is_number(value, numeric):
                        return numeric(value)
            return value
        if isinstance(value, str):
            for numeric in (float, int):
                if isinstance(template, numeric) and is_number(value, numeric):
                    return numeric(value)
        if type(value) is type(template):
            return value
        if isinstance(value, int) and isinstance(template, float):
            return float(value)
        if isinstance(value, bool) and isinstance(template, str):
            return str(value)
        return value

    def _descend(self, key: str, create: bool):
        """Walk ``self.options`` to the dict that holds the last segment of
        dotted ``key``. Returns ``(node, leaf_name, may_create)`` where
        ``may_create`` reflects whether a ``+++`` extension point anywhere
        along the path (or the ``create`` argument) permits new keys."""
        segments = key.split(".")
        node = self.options
        for depth, segment in enumerate(segments[:-1]):
            create = create or "+++" in node
            if create and segment not in node:
                node[segment] = {}
            child = node[segment]
            if not isinstance(child, dict):
                raise ValueError(
                    "cannot set {} because {} is already a value".format(
                        key, ".".join(segments[: depth + 1])
                    )
                )
            node = child
        return node, segments[-1], create or "+++" in node

    def set(
        self,
        key: str,
        value,
        create: bool = False,
        overwrite=Overwrite.Yes,
        log: bool = False,
    ) -> Any:
        """Assign ``value`` to dotted ``key`` with type checking.

        New keys are admitted only when ``create`` is given or an enclosing
        node carries the ``+++`` extension marker. The value is coerced
        toward the type of the entry it replaces (see ``_coerce``);
        irreconcilable types are an error. ``overwrite`` governs collisions
        with an existing value: ``Yes`` replaces it, ``No``/``DefaultOnly``
        keep it, ``Error`` rejects any change.
        """
        node, leaf, may_create = self._descend(key, create)
        previous = node.get(leaf)
        value = Config._coerce(value, previous)
        if key == "modules" and isinstance(value, list):
            # folders and checkpoints of the JAX package name its modules
            value = [misc.port_module_name(m) for m in value]

        if previous is None:
            if not may_create:
                raise KeyError(
                    f"key {key} not present and no new keys allowed here"
                )
        else:
            if type(value) is not type(previous):
                raise ValueError(
                    "key {} has incorrect type (expected {}, found {})".format(
                        key, type(previous), type(value)
                    )
                )
            if overwrite in (Config.Overwrite.No, Config.Overwrite.DefaultOnly):
                return previous
            if overwrite == Config.Overwrite.Error and value != previous:
                raise ValueError(f"key {key} cannot be overwritten")

        node[leaf] = value
        if log:
            self.log(f"Set {key}={value}")
        return value

    def set_all(self, new_options: Dict[str, Any], create=False, overwrite=Overwrite.Yes):
        for key, value in Config.flatten(new_options).items():
            self.set(key, value, create, overwrite)

    def _import(self, module_name: str):
        """Merge the yaml options of configuration module ``module_name``.

        Searches the directories of the python modules listed under config key
        ``modules`` for a file ``<module_name>.yaml`` and merges it into this
        configuration as defaults (existing values win).
        """
        import_path = None
        for m in self.get("modules"):
            try:
                import_path = misc.filename_in_module(m, f"{module_name}.yaml")
                break
            except (FileNotFoundError, ModuleNotFoundError):
                pass
        if import_path is None:
            raise ValueError(f"could not find configuration file {module_name}.yaml")

        with open(import_path, "r") as f:
            module_options = yaml.safe_load(f)

        # the file may itself request more imports
        if "import" in module_options:
            for m in module_options.get("import"):
                self._import(m)
            del module_options["import"]

        # add/verify current options (defaults only: user options win)
        self.set_all(module_options, create=True, overwrite=Config.Overwrite.DefaultOnly)

        # remember the import
        imports = self.options.get("import", [])
        if not isinstance(imports, list):
            imports = [imports]
        if module_name not in imports:
            imports.append(module_name)
        self.options["import"] = list(set(imports))

    def load(
        self,
        filename: str,
        create=False,
        overwrite=Overwrite.Yes,
        allow_deprecated=True,
    ):
        """Update options with options from the specified yaml file."""
        with open(filename, "r") as f:
            new_options = yaml.safe_load(f)
        if new_options is not None:
            self.load_options(
                new_options,
                create=create,
                overwrite=overwrite,
                allow_deprecated=allow_deprecated,
            )

    def load_options(self, new_options, create=False, overwrite=Overwrite.Yes,
                     allow_deprecated=True):
        """Update options with the given options dict."""
        # process deprecated keys first so renamed model/module names import
        # correctly (matches the reference's load order, kge/config.py:362-396)
        new_options = Config.flatten(new_options)
        if allow_deprecated:
            new_options = _process_deprecated_options(new_options, self)
        # import model configurations
        model = new_options.get("model")
        if model:
            self._import(model)
        if "import" in new_options:
            imports = new_options.get("import")
            if not isinstance(imports, list):
                imports = [imports]
            for module_name in imports:
                self._import(module_name)
            del new_options["import"]
        self.set_all(new_options, create, overwrite)

    def load_config(self, config: "Config", create=False, overwrite=Overwrite.Yes):
        self.set_all(config.options, create, overwrite)

    def _shared_options(self) -> Dict[str, Any]:
        """The options as files shared with the JAX package hold them: its
        module names under ``modules`` (read back as this package's)."""
        options = dict(self.options)
        if isinstance(options.get("modules"), list):
            options["modules"] = [
                misc.jax_module_name(m) for m in options["modules"]
            ]
        return options

    def save(self, filename: str):
        with open(filename, "w+") as file:
            file.write(yaml.dump(self._shared_options(), default_flow_style=False))

    def __getstate__(self):
        # pickled into checkpoints, which the JAX package reads too; every
        # lookup here reads its module names as this package's (misc.py)
        state = dict(self.__dict__)
        state["options"] = self._shared_options()
        return state

    def save_to(self, checkpoint: Dict) -> Dict:
        """Adds the config file to a checkpoint dict."""
        checkpoint["config"] = self
        return checkpoint

    @staticmethod
    def flatten(options: Dict[str, Any]) -> Dict[str, Any]:
        """Return a dict of flattened dotted-key options."""
        result: Dict[str, Any] = {}
        Config.__flatten(options, result)
        return result

    @staticmethod
    def __flatten(options: Dict[str, Any], result: Dict, prefix=""):
        for key, value in options.items():
            fullkey = key if prefix == "" else prefix + "." + key
            if isinstance(value, dict):
                Config.__flatten(value, result, prefix=fullkey)
            else:
                result[fullkey] = value

    def clone(self, subfolder: Optional[str] = None) -> "Config":
        """Return a deep copy; optionally resolve folder to a subfolder."""
        new_config = copy.deepcopy(self)
        if subfolder is not None:
            new_config.folder = os.path.join(self.folder, subfolder)
        return new_config

    # -- LOGGING AND TRACING --------------------------------------------------

    def log(self, msg: str, echo: bool = True, prefix: str = ""):
        """Add a message to the default log file (and optionally console);
        only rank 0 of a run over several processes writes or echoes."""
        if not _is_primary_process():
            return
        with open(self.logfile(), "a") as file:
            for line in msg.splitlines():
                if prefix:
                    line = prefix + line
                if self.log_prefix:
                    line = self.log_prefix + line
                if echo:
                    self.print(line)
                file.write(f"{datetime.datetime.now()} {line}\n")

    def print(self, *args, **kwargs):
        """Print unless quiet or a rank other than 0."""
        if not self.get("console.quiet") and _is_primary_process():
            print(*args, **kwargs)

    def trace(
        self, echo=False, echo_prefix="", echo_flow=False, log=False, **kwargs
    ) -> Dict[str, Any]:
        """Write a set of key-value pairs to the trace file.

        Adds an automatic timestamp and unique ``entry_id``. Each entry is one
        single-line yaml record (same on-disk format as the reference
        kge/config.py:462 so that downstream tooling keeps working).
        """
        kwargs["timestamp"] = time.time()
        kwargs["entry_id"] = str(uuid.uuid4())
        line = yaml.dump(kwargs, width=float("inf"), default_flow_style=True).strip()
        if echo or log:
            msg = yaml.dump(kwargs, default_flow_style=echo_flow)
            if log:
                self.log(msg, echo, echo_prefix)
            else:
                for part in msg.splitlines():
                    self.print(echo_prefix + part)
        if _is_primary_process():
            with open(self.tracefile(), "a") as file:
                file.write(line + "\n")
        return kwargs

    # -- FOLDERS AND CHECKPOINTS ----------------------------------------------

    def init_folder(self) -> bool:
        """Initialize the output folder (write config.yaml). Returns True if
        the folder was newly created. Rank 0 alone creates it; every other
        rank of a run over several processes returns True."""
        if not _is_primary_process():
            return True
        if not os.path.exists(self.folder):
            os.makedirs(self.folder)
            os.makedirs(os.path.join(self.folder, "config"))
            self.save(os.path.join(self.folder, "config.yaml"))
            return True
        return False

    @staticmethod
    def create_from(checkpoint: Dict) -> "Config":
        """Create a config from a checkpoint."""
        config = Config()
        if "config" in checkpoint and checkpoint["config"] is not None:
            config_load = checkpoint["config"]
            if "model" in config_load.options and config_load.options["model"]:
                config._import(config_load.options["model"])
            config.load_config(config_load.clone(), create=True)
        if "folder" in checkpoint and checkpoint["folder"] is not None:
            config.folder = checkpoint["folder"]
        return config

    @staticmethod
    def from_options(options: Dict[str, Any] = {}, **more_options) -> "Config":
        config = Config()
        config.load_options(copy.deepcopy(options))
        config.load_options(more_options)
        return config

    def checkpoint_file(self, cpt_id: Union[str, int]) -> str:
        """Return path of checkpoint file for given id (number or 'best')."""
        from kge_tpu_torch.misc import is_number

        if is_number(cpt_id, int):
            return os.path.join(self.folder, "checkpoint_{:05d}.pt".format(int(cpt_id)))
        else:
            return os.path.join(self.folder, "checkpoint_{}.pt".format(cpt_id))

    def last_checkpoint_number(self) -> Optional[int]:
        """Return number of latest checkpoint in the folder, None if there is none."""
        found_epoch = -1
        if self.folder and os.path.exists(self.folder):
            for f in os.listdir(self.folder):
                if f.startswith("checkpoint_") and f.endswith(".pt"):
                    digits = f[len("checkpoint_") : -len(".pt")]
                    if digits.isdigit():
                        found_epoch = max(found_epoch, int(digits))
        if found_epoch >= 0:
            return found_epoch
        return None

    @staticmethod
    def best_or_last_checkpoint_file(path: str) -> str:
        """Return best (if present) or last checkpoint path in ``path``."""
        config = Config(folder=path, load_default=False)
        checkpoint_file = config.checkpoint_file("best")
        if os.path.isfile(checkpoint_file):
            return checkpoint_file
        cpt_epoch = config.last_checkpoint_number()
        if cpt_epoch is not None:
            return config.checkpoint_file(cpt_epoch)
        raise FileNotFoundError(f"Could not find checkpoint in {path}")

    # -- CONVENIENCE ----------------------------------------------------------

    def _check(self, key: str, value, allowed_values) -> Any:
        if value not in allowed_values:
            raise ValueError(
                "Illegal value {} for key {}; allowed values are {}".format(
                    value, key, allowed_values
                )
            )
        return value

    def check(self, key: str, allowed_values) -> Any:
        """Raise an error if the value of ``key`` is not in ``allowed_values``."""
        return self._check(key, self.get(key), allowed_values)

    def check_default(self, key: str, allowed_values) -> Any:
        return self._check(key, self.get_default(key), allowed_values)

    def check_range(self, key: str, min_value, max_value,
                    min_inclusive=True, max_inclusive=True) -> Any:
        value = self.get(key)
        if (
            value < min_value
            or (value == min_value and not min_inclusive)
            or value > max_value
            or (value == max_value and not max_inclusive)
        ):
            raise ValueError(
                "Illegal value {} for key {}; must be in range {}{},{}{}".format(
                    value,
                    key,
                    "[" if min_inclusive else "(",
                    min_value,
                    max_value,
                    "]" if max_inclusive else ")",
                )
            )
        return value

    def logdir(self) -> str:
        return self.log_folder if self.log_folder else self.folder

    def logfile(self) -> str:
        folder = self.logdir()
        if folder:
            return os.path.join(folder, "kge.log")
        else:
            return os.devnull

    def tracefile(self) -> str:
        folder = self.logdir()
        if folder:
            return os.path.join(folder, "trace.yaml")
        else:
            return os.devnull


class Configurable:
    """Mix-in class for objects that are configured by a configuration key.

    Provides ``get_option``/``set_option``/``check_option`` scoped to this
    object's ``configuration_key`` with type-hierarchy defaults.
    """

    def __init__(self, config: Config, configuration_key: str = None):
        self._init_configuration(config, configuration_key)

    def has_option(self, name: str) -> bool:
        try:
            self.get_option(name)
            return True
        except KeyError:
            return False

    def get_option(self, name: str) -> Any:
        if self.configuration_key:
            return self.config.get_default(self.configuration_key + "." + name)
        else:
            return self.config.get_default(name)

    def check_option(self, name: str, allowed_values) -> Any:
        if self.configuration_key:
            full_name = self.configuration_key + "." + name
        else:
            full_name = name
        return self.config._check(full_name, self.get_option(name), allowed_values)

    def set_option(self, name: str, value, **kwargs) -> Any:
        if self.configuration_key:
            return self.config.set(self.configuration_key + "." + name, value, **kwargs)
        else:
            return self.config.set(name, value, **kwargs)

    def _init_configuration(self, config: Config, configuration_key: Optional[str]):
        self.config = config
        self.configuration_key = configuration_key


def _process_deprecated_options(options: Dict[str, Any], config: Config = None):
    """Translate deprecated keys/values in a flat options dict.

    Implements the reference's full migration rule set
    (kge/config.py:693-904) so configs published for any LibKGE version load
    unchanged.
    """
    import re

    def warn(msg):
        if config is not None:
            config.print("Warning: " + msg)

    def rename_key(old_key, new_key):
        if old_key in options:
            warn(f"key {old_key} is deprecated; use key {new_key} instead")
            if new_key in options:
                raise ValueError(
                    f"keys {old_key} and {new_key} must not both be set"
                )
            options[new_key] = options.pop(old_key)
            return True
        return False

    def rename_value(key, old_value, new_value):
        if key in options and options.get(key) == old_value:
            warn(
                f"value {key}={old_value} is deprecated; use value "
                f"{new_value if new_value != '' else repr('')} instead"
            )
            options[key] = new_value
            return True
        return False

    def delete_key_with_value(key, value):
        if key in options:
            if options[key] == value:
                warn(f"key {key} is deprecated and has been removed; ignored")
                del options[key]
            else:
                raise ValueError(f"key {key} is deprecated and has been removed.")

    def delete_key_re_with_default_value(key_regex, value):
        regex = re.compile(key_regex)
        for old_key in list(options.keys()):
            if regex.match(old_key):
                if options[old_key] == value:
                    warn(f"key {old_key} is deprecated and has been removed; ignored")
                    del options[old_key]
                else:
                    raise ValueError(
                        f"key {old_key} is deprecated and has been removed; "
                        f"value {options[old_key]} is not supported any more."
                    )

    def rename_keys_re(key_regex, replacement):
        renamed = set()
        regex = re.compile(key_regex)
        for old_key in list(options.keys()):
            new_key = regex.sub(replacement, old_key)
            if old_key != new_key:
                rename_key(old_key, new_key)
                renamed.add(new_key)
        return renamed

    def rename_value_re(key_regex, old_value, new_value):
        renamed = set()
        regex = re.compile(key_regex)
        for key in options.keys():
            if regex.match(key) and rename_value(key, old_value, new_value):
                renamed.add(key)
        return renamed

    rename_key("train.auto_correct", "job.auto_correct")
    rename_key("entity_ranking.tie_handling", "entity_ranking.tie_handling.type")
    rename_value("search.type", "ax", "ax_search")
    rename_value("search.type", "manual", "manual_search")
    rename_value("search.type", "grid", "grid_search")
    if isinstance(options.get("train.optimizer"), str):
        rename_key("train.optimizer", "train.optimizer.default.type")
    rename_keys_re(r"^train\.optimizer_args", "train.optimizer.default.args")
    if "verbose" in options:
        rename_key("verbose", "console.quiet")
        options["console.quiet"] = not options["console.quiet"]
    tucker_reg_key = "tucker3_relation_embedder.regularize_args.p"
    if tucker_reg_key in options and isinstance(options[tucker_reg_key], int):
        options[tucker_reg_key] = float(options[tucker_reg_key])
    rename_keys_re(
        r"^valid\.early_stopping\.min_threshold\.",
        "valid.early_stopping.threshold.",
    )
    rename_key("negative_sampling.chunk_size", "train.subbatch_size")
    delete_key_re_with_default_value(r".*normalize.with_grad", False)
    rename_key("eval.filter_splits", "entity_ranking.filter_splits")
    rename_key("eval.filter_with_test", "entity_ranking.filter_with_test")
    rename_key("eval.tie_handling", "entity_ranking.tie_handling")
    rename_key("eval.hits_at_k_s", "entity_ranking.hits_at_k_s")
    rename_key("eval.chunk_size", "entity_ranking.chunk_size")
    rename_keys_re(r"^eval\.metrics_per\.", "entity_ranking.metrics_per.")
    delete_key_with_value("ax_search.fixed_parameters", [])
    rename_value("train.lr_scheduler", "ConstantLRScheduler", "")
    rename_key("eval.data", "eval.split")
    rename_key("valid.filter_with_test", "entity_ranking.filter_with_test")
    rename_value("negative_sampling.implementation", "spo", "triple")
    rename_value("negative_sampling.implementation", "sp_po", "batch")
    for slot in ("s", "p", "o"):
        rename_key(
            f"negative_sampling.num_samples_{slot}",
            f"negative_sampling.num_samples.{slot}",
        )
        rename_key(
            f"negative_sampling.filter_positives_{slot}",
            f"negative_sampling.filtering.{slot}",
        )
        rename_key(
            f"negative_sampling.filter_true_{slot}",
            f"negative_sampling.filtering.{slot}",
        )
        rename_key(
            f"negative_sampling.num_negatives_{slot}",
            f"negative_sampling.num_samples.{slot}",
        )
    for split in ("train", "valid", "test"):
        if f"dataset.{split}" in options:
            rename_key(f"dataset.{split}", f"dataset.files.{split}.filename")
            options[f"dataset.files.{split}.type"] = "triples"
    for obj in ("entity", "relation"):
        if f"dataset.{obj}_map" in options:
            rename_key(
                f"dataset.{obj}_map", f"dataset.files.{obj}_ids.filename"
            )
            options[f"dataset.files.{obj}_ids.type"] = "map"
    rename_value("train.loss", "ce", "kl")
    rename_keys_re(r"\.regularize_args\.weight$", ".regularize_weight")
    for p in (1, 2, 3):
        for key in rename_value_re(r".*\.regularize$", f"l{p}", "lp"):
            new_key = re.sub(r"\.regularize$", ".regularize_args.p", key)
            options[new_key] = p
    if rename_key(
        "negative_sampling.score_func_type", "negative_sampling.implementation"
    ):
        rename_value("negative_sampling.implementation", "spo", "triple")
        rename_value("negative_sampling.implementation", "sp_po", "batch")
    rename_value("train.type", "1toN", "KvsAll")
    rename_value("train.type", "spo", "1vsAll")
    rename_keys_re(r"^1toN\.", "KvsAll.")
    rename_key("checkpoint.every", "train.checkpoint.every")
    rename_key("checkpoint.keep", "train.checkpoint.keep")
    rename_value("model", "inverse_relations_model", "reciprocal_relations_model")
    rename_keys_re(r"^inverse_relations_model\.", "reciprocal_relations_model.")
    rename_key(
        "eval.metrics_per_relation_type",
        "entity_ranking.metrics_per.relation_type",
    )
    rename_key(
        "eval.metrics_per_head_and_tail",
        "entity_ranking.metrics_per.head_and_tail",
    )
    rename_key(
        "eval.metric_per_argument_frequency_perc",
        "entity_ranking.metrics_per.argument_frequency",
    )
    rename_key(
        "eval.metrics_per_argument_frequency",
        "entity_ranking.metrics_per.argument_frequency",
    )
    return options
