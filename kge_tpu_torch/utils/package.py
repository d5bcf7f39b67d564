"""Model packaging: strip training state from a checkpoint and embed the
entity/relation id maps, producing a standalone model file loadable with
``KgeModel.create_from`` (kge_tpu/utils/package.py; reference
kge/util/package.py). The file has kge_tpu's ``type: package`` schema, so
either package evaluates the other's."""

from __future__ import annotations

import os
from typing import Optional

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.utils.io import (
    get_checkpoint_file, load_checkpoint, save_checkpoint,
)


def package_model(input_checkpoint: str, output: Optional[str] = None,
                  dataset: Optional[Dataset] = None) -> str:
    """Convert a train checkpoint into a packaged model file.

    ``input_checkpoint`` may also be an experiment folder, in which case the
    best (or last) checkpoint is packaged (reference requires a file,
    kge/util/package.py:23-25; the folder form is a convenience).
    """
    if os.path.isdir(input_checkpoint):
        config = Config(folder=input_checkpoint)
        input_checkpoint = get_checkpoint_file(config, "best")
        if input_checkpoint is None:
            raise ValueError(f"no checkpoint found in folder {config.folder}")
    checkpoint = load_checkpoint(input_checkpoint)
    if checkpoint["type"] != "train":
        raise ValueError("can only package train checkpoints")
    if output is None:
        # reference naming: checkpoint_best.pt -> model_best.pt
        # (kge/util/package.py:40-46)
        folder, filename = os.path.split(input_checkpoint)
        if "checkpoint" in filename:
            filename = filename.replace("checkpoint", "model")
        else:
            filename = os.path.splitext(filename)[0] + "_package.pt"
        output = os.path.join(folder, filename)

    config = Config.create_from(checkpoint)
    if dataset is None:
        dataset = Dataset.create_from(checkpoint, config, preload_data=False)

    packaged = {
        "type": "package",
        "model": checkpoint["model"],
        "valid_trace": checkpoint.get("valid_trace", []),
        "epoch": checkpoint.get("epoch"),
        "job_id": checkpoint.get("job_id"),
    }
    packaged = config.save_to(packaged)
    packaged = dataset.save_to(packaged, ["entity_ids", "relation_ids"])
    save_checkpoint(packaged, output)
    return output


def add_package_parser(subparsers):
    parser = subparsers.add_parser(
        "package", help="Create a packaged model from a checkpoint"
    )
    parser.add_argument("checkpoint", type=str, help="checkpoint file to package")
    parser.add_argument("--file", "-f", type=str, default=None,
                        help="output file name")
