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
name only, so that kge_tpu reads it back. float16 leaves
(``parallel.param_dtype: float16``) are numpy's own ``float16`` arrays in
both packages' checkpoints and need no such stand-in.

Sharded checkpoints keep kge_tpu's schema (kge_tpu/utils/io.py): under a
model axis every rank writes ``<file>.shardNNNNN`` holding ``{"process":
rank, "shards": {path id: [(index, array)]}}`` (the ranks of data row 0
their rows of the entity table and of its optimizer state, the others
nothing), and after a barrier rank 0 writes the main file, in which those
leaves are ``__kge_sharded_leaf__`` markers, with ``num_shard_files``.
Loading reassembles the whole leaves from the shard files, whichever
package wrote them.
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


SHARDED_MARKER = "__kge_sharded_leaf__"


def shard_filename(filename: str, process: int) -> str:
    return f"{filename}.shard{process:05d}"


def _dump(obj, filename: str) -> None:
    """Pickle ``obj`` to ``filename`` atomically (through a temporary)."""
    tmpfile = filename + ".tmp"
    with open(tmpfile, "wb") as f:
        _PortPickler(f, protocol=pickle.HIGHEST_PROTOCOL).dump(obj)
    os.replace(tmpfile, filename)


def _tree_map(fn, tree, path=()):
    """``fn(path, leaf)`` over nested dicts, lists and tuples, the path's
    elements dict keys and list positions (kge_tpu's ``_leaf_path_id``
    parts)."""
    if isinstance(tree, dict):
        return {k: _tree_map(fn, v, path + (k,)) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(
            _tree_map(fn, v, path + (i,)) for i, v in enumerate(tree))
    return fn(path, tree)


def _path_id(prefix: str, path) -> str:
    return prefix + "/".join(str(p) for p in path)


def _dtype_name(leaf) -> str:
    if isinstance(leaf, torch.Tensor):
        return str(leaf.dtype).replace("torch.", "")
    return str(np.asarray(leaf).dtype)


def save_checkpoint(checkpoint: Dict[str, Any], filename: str,
                    row_shards: Optional[Dict[str, Any]] = None):
    """Atomically write a checkpoint. ``row_shards`` (a training job's
    ``_row_shards``) names the leaves that are this rank's row shards,
    ``{"paths": {path id: (lo, hi, rows)}, "write": bool}``: they go to the
    rank's shard file as kge_tpu's sharded leaves (an empty one where
    ``write`` is false), and rank 0 publishes the main file with their
    markers once every rank's shard file is on disk."""
    from kge_tpu_torch.parallel import distributed

    if row_shards:
        paths, local = row_shards["paths"], {}

        def split(prefix):
            def visit(path, leaf):
                path_id = _path_id(prefix, path)
                if path_id not in paths:
                    return leaf
                lo, hi, rows = paths[path_id]
                if row_shards["write"]:
                    index = ((lo, hi),) + ((None, None),) * (leaf.ndim - 1)
                    local[path_id] = [(index, leaf)]
                return {SHARDED_MARKER: True,
                        "shape": (rows,) + tuple(leaf.shape[1:]),
                        "dtype": _dtype_name(leaf), "path": path_id}
            return visit

        params, meta = checkpoint["model"]
        checkpoint["model"] = (_tree_map(split("model/"), params), meta)
        if checkpoint.get("optimizer_state") is not None:
            checkpoint["optimizer_state"] = _tree_map(
                split("opt/"), checkpoint["optimizer_state"])
        rank = distributed.process_index()
        _dump({"process": rank, "shards": local},
              shard_filename(filename, rank))
        checkpoint["num_shard_files"] = distributed.world_size()
        # rank 0 publishes the main file (after which the caller may
        # delete the previous checkpoint) only once every shard is written
        distributed.barrier(f"save_checkpoint:{os.path.basename(filename)}")
    if not distributed.is_primary():
        return
    if row_shards:
        missing = [shard_filename(filename, p)
                   for p in range(checkpoint["num_shard_files"])
                   if not os.path.isfile(shard_filename(filename, p))]
        if missing:
            raise RuntimeError(
                f"checkpoint shard files missing: {missing}; refusing to "
                "publish an unloadable checkpoint")
    _dump(checkpoint, filename)


def _is_marker(leaf) -> bool:
    return isinstance(leaf, dict) and leaf.get(SHARDED_MARKER) is True


def _walk(fn, tree):
    """``fn`` on the markers and leaves of nested dicts, lists and tuples."""
    if _is_marker(tree):
        return fn(tree)
    if isinstance(tree, dict):
        return {k: _walk(fn, v) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_walk(fn, v) for v in tree)
    return fn(tree)


def _reassemble_sharded(checkpoint: Dict, checkpoint_file: str,
                        rows=None) -> Dict:
    """Resolve kge_tpu's sharded-leaf markers from the per-process shard
    files next to the checkpoint (kge_tpu/utils/io.py
    ``_reassemble_sharded``): whole numpy arrays, or CPU bfloat16 tensors.
    ``rows`` = (lo, hi) keeps rows [lo, hi) of every sharded leaf (they
    shard by rows, the entity table and its optimizer state) and nothing
    else of it."""
    num = checkpoint.pop("num_shard_files", 0)
    if not num:
        return checkpoint
    markers = {}

    def collect(leaf):
        if _is_marker(leaf):
            markers[leaf["path"]] = leaf
        return leaf

    _walk(collect, (checkpoint.get("model"), checkpoint.get("optimizer_state")))
    lo, hi = rows if rows is not None else (0, None)
    assembled = {}
    for path_id, marker in markers.items():
        shape = tuple(marker["shape"])
        if rows is not None:
            shape = (hi - lo,) + shape[1:]
        if marker["dtype"] == "bfloat16":
            assembled[path_id] = torch.empty(shape, dtype=torch.bfloat16)
        else:
            assembled[path_id] = np.empty(shape, dtype=np.dtype(marker["dtype"]))
    for p in range(num):
        shard_file = shard_filename(checkpoint_file, p)
        if not os.path.isfile(shard_file):
            raise FileNotFoundError(
                f"missing checkpoint shard file {shard_file} ({num} "
                "expected; was the checkpoint copied without its shard "
                "files?)"
            )
        with open(shard_file, "rb") as f:
            payload = _resolve(_PortUnpickler(f).load(), {})
        for path_id, shards in payload["shards"].items():
            target = assembled.get(path_id)
            if target is None:
                continue
            for index, data in shards:
                at = tuple(slice(a, b) for a, b in index)
                if rows is not None:
                    # the piece's rows that fall in [lo, hi), moved by lo
                    first = at[0].start or 0
                    last = first + len(data)
                    a, b = max(first, lo), min(last, hi)
                    if a >= b:
                        continue
                    data = data[a - first:b - first]
                    at = (slice(a - lo, b - lo),) + at[1:]
                if isinstance(target, torch.Tensor):
                    target[at] = torch.as_tensor(data)
                else:
                    target[at] = np.asarray(data)

    def resolve(leaf):
        return assembled[leaf["path"]] if _is_marker(leaf) else leaf

    if checkpoint.get("model") is not None:
        params, *meta = checkpoint["model"]
        checkpoint["model"] = (_walk(resolve, params), *meta)
    if checkpoint.get("optimizer_state") is not None:
        checkpoint["optimizer_state"] = _walk(
            resolve, checkpoint["optimizer_state"])
    return checkpoint


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


def load_checkpoint(checkpoint_file: str, rows=None) -> Dict:
    """Load a checkpoint; adds its file/folder for downstream resume logic
    (reference kge/util/io.py:36-47). A sharded one (kge_tpu's multi-host
    runs, or a model axis here) is reassembled from its shard files; with
    ``rows`` = (lo, hi) only those rows of its sharded leaves, which is
    what a rank of a model axis holds."""
    with open(checkpoint_file, "rb") as f:
        checkpoint = _resolve(_PortUnpickler(f).load(), {})
    checkpoint = _reassemble_sharded(checkpoint, checkpoint_file, rows)
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
