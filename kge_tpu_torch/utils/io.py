"""Checkpoint serialization.

Checkpoints are pickled dicts with kge_tpu's schema (kge_tpu/utils/io.py,
after the reference kge/job/train.py:276-298): ``{type, epoch, valid_trace,
model: (params, meta), optimizer_state, lr_scheduler_state_dict, job_id,
config, dataset{...}}`` with numpy arrays as parameter leaves. A
checkpoint written by kge_tpu pickles its ``Config`` object and names its
modules (``kge_tpu.job``, ...); loading maps every ``kge_tpu.*`` class and
module name to this package's, so it never imports kge_tpu.

bfloat16 leaves (``parallel.param_dtype: bfloat16``) are numpy arrays of
``ml_dtypes.bfloat16`` in kge_tpu's checkpoints. This package uses neither
that package nor a numpy bfloat16: it reads such an array as a CPU
``torch.bfloat16`` tensor from its raw 2-byte buffer, and writes a
bfloat16 tensor as the pickle of such an array, naming ``ml_dtypes`` by
name only, so that kge_tpu reads it back.
"""

from __future__ import annotations

import os
import pickle
from typing import Any, Dict, Optional

import numpy as np
import torch

from kge_tpu_torch import misc
from kge_tpu_torch.config import Config

_ARRAY_MODULES = ("numpy._core.multiarray", "numpy.core.multiarray")
#: numpy's state of ``dtype(ml_dtypes.bfloat16)``, as numpy pickles it
_BF16_DTYPE_STATE = (3, "<", None, None, None, 2, 2, 64)


class _Bfloat16:
    """Stands in for ``ml_dtypes.bfloat16`` while a checkpoint loads."""


class _Bfloat16Dtype:
    """What ``numpy.dtype(ml_dtypes.bfloat16, ...)`` unpickles to here."""

    def __setstate__(self, state):
        pass


class _PendingArray:
    """A numpy array being unpickled: its state (version, shape, dtype,
    Fortran order, raw data) arrives after it is created, and decides
    whether it becomes a numpy array or a bfloat16 tensor
    (``_resolve``)."""

    def __setstate__(self, state):
        self.state = state


def _dtype(obj, *args):
    return _Bfloat16Dtype() if obj is _Bfloat16 else np.dtype(obj, *args)


def _reconstruct(cls, shape, dtype):
    if cls is np.ndarray:
        return _PendingArray()
    return _reconstruct_global()(cls, shape, dtype)


def _bfloat16_tensor(raw, shape, fortran=False) -> torch.Tensor:
    values = torch.frombuffer(bytearray(raw), dtype=torch.bfloat16)
    if fortran:
        return values.reshape(tuple(reversed(shape))).permute(
            *reversed(range(len(shape)))).contiguous()
    return values.reshape(tuple(shape))


def _resolve(obj, seen):
    """``obj`` with every ``_PendingArray`` inside dicts, lists and tuples
    made a numpy array, or a bfloat16 tensor."""
    key = id(obj)
    if key in seen:
        return seen[key]
    if isinstance(obj, _PendingArray):
        _, shape, dtype, fortran, raw = obj.state
        if isinstance(dtype, _Bfloat16Dtype):
            out = _bfloat16_tensor(raw, shape, fortran)
        else:
            out = np.ndarray.__new__(np.ndarray, (0,), np.uint8)
            out.__setstate__(obj.state)
    elif isinstance(obj, dict):
        out = obj
        for k, v in list(obj.items()):
            obj[k] = _resolve(v, seen)
    elif isinstance(obj, list):
        out = obj
        obj[:] = [_resolve(v, seen) for v in obj]
    elif isinstance(obj, tuple):
        out = tuple(_resolve(v, seen) for v in obj)
    else:
        out = obj
    seen[key] = out
    return out


class _PortUnpickler(pickle.Unpickler):
    """Reads classes of the JAX package as this package's classes, and
    numpy arrays of ``ml_dtypes.bfloat16`` without that package."""

    def find_class(self, module: str, name: str):
        if (module, name) == ("ml_dtypes", "bfloat16"):
            return _Bfloat16
        if (module, name) == ("numpy", "dtype"):
            return _dtype
        if module in _ARRAY_MODULES and name == "_reconstruct":
            return _reconstruct
        return super().find_class(misc.port_module_name(module), name)


class _Bfloat16Global:
    """Pickled as the global ``ml_dtypes.bfloat16``."""


class _Bfloat16DtypeRef:
    """Pickled as ``numpy.dtype(ml_dtypes.bfloat16, False, True)``."""

    def __reduce__(self):
        return np.dtype, (_Bfloat16Global(), False, True), _BF16_DTYPE_STATE


class _PortPickler(pickle._Pickler):
    """Pickles a CPU ``torch.bfloat16`` tensor as numpy pickles an array of
    ``ml_dtypes.bfloat16`` (the same opcodes), the global named but not
    imported: the pure-Python pickler, whose globals can be written by
    hand. Arrays go out as raw bytes either way."""

    def reducer_override(self, obj):
        if isinstance(obj, torch.Tensor) and obj.dtype == torch.bfloat16:
            raw = obj.detach().cpu().contiguous().view(torch.int16).numpy().tobytes()
            return (_reconstruct_global(), (np.ndarray, (0,), b"b"),
                    (1, tuple(obj.shape), _Bfloat16DtypeRef(), False, raw))
        return NotImplemented

    def save(self, obj, save_persistent_id=True):
        if isinstance(obj, _Bfloat16Global):
            self.save("ml_dtypes")
            self.save("bfloat16")
            self.write(pickle.STACK_GLOBAL)
            return
        super().save(obj, save_persistent_id)


def _reconstruct_global():
    """numpy's ``_reconstruct``, pickled by its own module's name."""
    return np.ndarray.__reduce__(np.empty(0))[0]


def save_checkpoint(checkpoint: Dict[str, Any], filename: str):
    """Atomically write a checkpoint (single process)."""
    tmpfile = filename + ".tmp"
    with open(tmpfile, "wb") as f:
        _PortPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(checkpoint)
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
        checkpoint = _resolve(_PortUnpickler(f).load(), {})
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
