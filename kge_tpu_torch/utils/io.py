"""Checkpoint serialization.

Checkpoints are pickled dicts with kge_tpu's schema (kge_tpu/utils/io.py,
after the reference kge/job/train.py:276-298): ``{type, epoch, valid_trace,
model: (params, meta), optimizer_state, lr_scheduler_state_dict, job_id,
config, dataset{...}}`` with numpy arrays as parameter leaves. A
checkpoint written by kge_tpu pickles its ``Config`` object and names its
modules (``kge_tpu.job``, ...); loading maps every ``kge_tpu.*`` class and
module name to this package's, so it never imports kge_tpu.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

from kge_tpu_torch import misc
from kge_tpu_torch.config import Config


class _PortUnpickler(pickle.Unpickler):
    """Reads classes of the JAX package as this package's classes."""

    def find_class(self, module: str, name: str):
        return super().find_class(misc.port_module_name(module), name)


def save_checkpoint(checkpoint: Dict[str, Any], filename: str):
    """Atomically write a checkpoint (single process)."""
    tmpfile = filename + ".tmp"
    with open(tmpfile, "wb") as f:
        pickle.dump(checkpoint, f, protocol=pickle.HIGHEST_PROTOCOL)
    os.replace(tmpfile, filename)


def get_checkpoint_file(config: Config, checkpoint_arg: str = "default") -> Optional[str]:
    """Resolve a CLI checkpoint argument ('default', 'last', 'best', a
    number, or a filename) to a path (reference kge/util/io.py:7-33)."""
    from kge_tpu_torch.misc import is_number

    if checkpoint_arg == "default":
        if config.get("job.type") in ("eval", "valid", "test"):
            checkpoint_arg = "best"
        else:
            checkpoint_arg = "last"
    if checkpoint_arg == "last":
        cpt_epoch = config.last_checkpoint_number()
        if cpt_epoch is None:
            return None
        return config.checkpoint_file(cpt_epoch)
    elif checkpoint_arg == "best":
        f = config.checkpoint_file("best")
        if os.path.isfile(f):
            return f
        cpt_epoch = config.last_checkpoint_number()
        return config.checkpoint_file(cpt_epoch) if cpt_epoch is not None else None
    elif is_number(checkpoint_arg, int):
        return config.checkpoint_file(int(checkpoint_arg))
    else:
        return checkpoint_arg


def load_checkpoint(checkpoint_file: str) -> Dict:
    """Load a checkpoint; adds its file/folder for downstream resume logic
    (reference kge/util/io.py:36-47)."""
    with open(checkpoint_file, "rb") as f:
        checkpoint = _PortUnpickler(f).load()
    if checkpoint.pop("num_shard_files", 0):
        raise NotImplementedError(
            f"{checkpoint_file} is sharded over hosts; loading sharded "
            "checkpoints is not ported yet (see ROADMAP.md)"
        )
    config = checkpoint.get("config")
    if isinstance(config, Config) and "modules" in config.options:
        config.options["modules"] = [
            misc.port_module_name(m) for m in config.options["modules"]
        ]
    checkpoint["file"] = checkpoint_file
    folder = os.path.dirname(checkpoint_file)
    if "config" in checkpoint and folder:
        checkpoint["folder"] = folder
    return checkpoint
