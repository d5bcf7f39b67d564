"""Dataset preprocessing toolkit.

Converts raw text splits (``train.txt``/``valid.txt``/``test.txt`` with
tab-separated subject/relation/object strings) into the framework's dense
``.del`` format plus ``dataset.yaml``, and derives the auxiliary splits the
reference produces (kge/data/preprocess/util.py): a small training sample
(``train_sample``) and valid/test splits filtered to entities and relations
seen in training (``*_without_unseen``). Labeled datasets (e.g. WN11, where
valid/test triples carry a +1/-1 label column) keep their labels in separate
files. The package's own copy of ``kge_tpu/data/preprocess.py``: both write
the same files, byte for byte.

Usage: ``python -m kge_tpu_torch.data.preprocess <folder> [--order_sop]
[--labeled]``; ``dataset.from_dir`` runs it on a raw folder in place.
"""
from __future__ import annotations

import argparse
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import yaml


class RawSplit:
    """A raw text split: order S, P, O (or S, P, O, label)."""

    def __init__(self, file: str, field_map: Optional[Dict[str, int]] = None,
                 collect_entities: bool = False,
                 collect_relations: bool = False):
        self.file = file
        self.field_map = field_map or {"S": 0, "P": 1, "O": 2}
        self.collect_entities = collect_entities
        self.collect_relations = collect_relations
        self.raw_data: List[List[str]] = []
        self.size = 0

    def read(self, folder: str):
        path = os.path.join(folder, self.file)
        with open(path, "r", encoding="utf-8") as f:
            self.raw_data = [
                line.rstrip("\n").split("\t") for line in f if line.strip()
            ]
        self.size = len(self.raw_data)


def analyze_raw_splits(splits: List[RawSplit], folder: str):
    """Read the raw splits and build dense entity/relation index maps from
    the splits marked for collection (usually train)."""
    entities: Dict[str, int] = {}
    relations: Dict[str, int] = {}
    for split in splits:
        split.read(folder)
    for split in splits:
        S, P, O = (split.field_map[k] for k in ("S", "P", "O"))
        for row in split.raw_data:
            if split.collect_entities:
                for field in (S, O):
                    if row[field] not in entities:
                        entities[row[field]] = len(entities)
            if split.collect_relations:
                if row[P] not in relations:
                    relations[row[P]] = len(relations)
    # entities/relations appearing only outside collected splits get ids too
    for split in splits:
        S, P, O = (split.field_map[k] for k in ("S", "P", "O"))
        for row in split.raw_data:
            for field in (S, O):
                if row[field] not in entities:
                    entities[row[field]] = len(entities)
            if row[P] not in relations:
                relations[row[P]] = len(relations)
    return entities, relations


def _encode(split: RawSplit, entities, relations) -> np.ndarray:
    S, P, O = (split.field_map[k] for k in ("S", "P", "O"))
    out = np.empty((split.size, 3), dtype=np.int64)
    for i, row in enumerate(split.raw_data):
        out[i] = (entities[row[S]], relations[row[P]], entities[row[O]])
    return out


def _labels(split: RawSplit) -> Optional[np.ndarray]:
    if "label" not in split.field_map:
        return None
    col = split.field_map["label"]
    return np.array(
        [int(row[col]) for row in split.raw_data], dtype=np.int64
    )


def process_splits(
    folder: str,
    splits: Dict[str, RawSplit],
    order_sop: bool = False,
    sample_seed: int = 0,
) -> Dict[str, Dict]:
    """Encode splits, derive auxiliary splits, and write all files.

    Returns the ``files`` section for dataset.yaml.
    """
    entities, relations = analyze_raw_splits(list(splits.values()), folder)
    files: Dict[str, Dict] = {}

    def write_triples(key: str, arr: np.ndarray):
        filename = f"{key}.del"
        np.savetxt(os.path.join(folder, filename), arr, fmt="%d",
                   delimiter="\t")
        files[key] = {
            "filename": filename, "type": "triples", "size": int(len(arr))
        }

    encoded: Dict[str, np.ndarray] = {}
    for key, split in splits.items():
        arr = _encode(split, entities, relations)
        encoded[key] = arr
        write_triples(key, arr)
        labels = _labels(split)
        if labels is not None:
            label_file = f"{key}_labels.del"
            np.savetxt(os.path.join(folder, label_file), labels, fmt="%d")
            files[f"{key}_labels"] = {
                "filename": label_file, "type": "labels", "size": int(len(labels))
            }

    train = encoded.get("train")
    if train is not None:
        # train_sample: a uniform sample of train, sized like valid
        sample_size = len(encoded.get("valid", train))
        rng = np.random.default_rng(sample_seed)
        sample = train[rng.choice(len(train), min(sample_size, len(train)),
                                  replace=False)]
        write_triples("train_sample", sample)

        seen_entities = np.zeros(len(entities), dtype=bool)
        seen_entities[train[:, 0]] = True
        seen_entities[train[:, 2]] = True
        seen_relations = np.zeros(len(relations), dtype=bool)
        seen_relations[train[:, 1]] = True
        for key in ("valid", "test"):
            if key not in encoded:
                continue
            arr = encoded[key]
            mask = (
                seen_entities[arr[:, 0]] & seen_entities[arr[:, 2]]
                & seen_relations[arr[:, 1]]
            )
            write_triples(f"{key}_without_unseen", arr[mask])

    # id maps
    with open(os.path.join(folder, "entity_ids.del"), "w",
              encoding="utf-8") as f:
        for name, idx in sorted(entities.items(), key=lambda kv: kv[1]):
            f.write(f"{idx}\t{name}\n")
    with open(os.path.join(folder, "relation_ids.del"), "w",
              encoding="utf-8") as f:
        for name, idx in sorted(relations.items(), key=lambda kv: kv[1]):
            f.write(f"{idx}\t{name}\n")
    files["entity_ids"] = {"filename": "entity_ids.del", "type": "map"}
    files["relation_ids"] = {"filename": "relation_ids.del", "type": "map"}
    return {
        "files": files,
        "num_entities": len(entities),
        "num_relations": len(relations),
    }


def write_dataset_yaml(folder: str, name: str, info: Dict):
    config = {
        "dataset": {
            "name": name,
            "num_entities": info["num_entities"],
            "num_relations": info["num_relations"],
        }
    }
    for key, meta in info["files"].items():
        for field, value in meta.items():
            config["dataset"][f"files.{key}.{field}"] = value
    with open(os.path.join(folder, "dataset.yaml"), "w") as f:
        yaml.dump(config, f, default_flow_style=False)


def preprocess_default(folder: str, order_sop: bool = False,
                       labeled: bool = False) -> Dict:
    """Standard preprocessing of a folder with train/valid/test.txt.

    ``order_sop`` handles datasets stored subject-object-predicate;
    ``labeled`` marks datasets whose valid/test have a label column (WN11).
    """
    if order_sop:
        field_map = {"S": 0, "P": 2, "O": 1}
    else:
        field_map = {"S": 0, "P": 1, "O": 2}
    valid_map = dict(field_map)
    test_map = dict(field_map)
    if labeled:
        valid_map["label"] = 3
        test_map["label"] = 3
    splits = {
        "train": RawSplit("train.txt", field_map,
                          collect_entities=True, collect_relations=True),
        "valid": RawSplit("valid.txt", valid_map),
        "test": RawSplit("test.txt", test_map),
    }
    info = process_splits(folder, splits, order_sop=order_sop)
    name = os.path.basename(os.path.abspath(folder))
    write_dataset_yaml(folder, name, info)
    return info


def main():
    parser = argparse.ArgumentParser(
        description="Preprocess a raw train/valid/test.txt dataset folder"
    )
    parser.add_argument("folder")
    parser.add_argument("--order_sop", action="store_true",
                        help="fields are ordered subject/object/predicate")
    parser.add_argument("--labeled", action="store_true",
                        help="valid/test carry a +1/-1 label column (WN11)")
    args = parser.parse_args()
    info = preprocess_default(args.folder, args.order_sop, args.labeled)
    print(
        f"Preprocessed {args.folder}: {info['num_entities']} entities, "
        f"{info['num_relations']} relations"
    )


if __name__ == "__main__":
    main()
