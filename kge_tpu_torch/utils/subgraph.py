"""K-core subgraph machinery for multi-fidelity search
(kge_tpu/utils/subgraph.py; the reference KCoreManager, kge/util/subgraph.py,
without igraph): core numbers come from an iterative-peeling k-core
decomposition over the training graph (entities as vertices, triples as
undirected edges), and per-k subset datasets are written under
``<dataset>/subsets/<k>-core/`` with reindexed ids, a fresh train/valid
split, a dataset.yaml, and a subset_stats.yaml: the same files, byte for
byte, as kge_tpu writes for the same dataset and seed.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import yaml

from kge_tpu_torch.config import Config
from kge_tpu_torch.dataset import Dataset


def core_numbers(num_vertices: int, edges: np.ndarray) -> np.ndarray:
    """Core number of every vertex (iterative peeling, vectorized rounds).

    ``edges`` is [m, 2]; parallel edges count toward the degree (consistent
    with a multigraph decomposition of the triple set).
    """
    core = np.zeros(num_vertices, dtype=np.int64)
    alive_edges = np.ones(len(edges), dtype=bool)
    alive = np.ones(num_vertices, dtype=bool)
    k = 1
    while alive.any():
        # peel all vertices with degree < k repeatedly
        while True:
            e = edges[alive_edges]
            deg = np.bincount(e.reshape(-1), minlength=num_vertices)
            remove = alive & (deg < k)
            if not remove.any():
                break
            alive = alive & ~remove
            if not alive.any():
                break
            alive_edges = alive_edges & alive[edges[:, 0]] & alive[edges[:, 1]]
        core[alive] = k
        k += 1
    return core


class KCoreManager:
    """Builds and registers k-core subset datasets of a training graph."""

    def __init__(self, config: Config, dataset: Dataset):
        self.config = config
        self.dataset = dataset
        self.folder = dataset.folder
        self.subsets_folder = os.path.join(self.folder, "subsets")
        self._stats: Optional[List[Dict]] = None

    def stats_file(self) -> str:
        return os.path.join(self.subsets_folder, "subset_stats.yaml")

    def decompose(self, valid_frac: float = 0.2, valid_max: int = 5000,
                  seed: int = 0) -> List[Dict]:
        """Compute all k-core subsets, writing each as a derived dataset.

        Returns per-subset stats: {k, folder, num_entities, num_relations,
        num_train, relative_triples, relative_entities}.
        """
        if self._stats is not None:
            return self._stats
        if os.path.isfile(self.stats_file()):
            with open(self.stats_file()) as f:
                self._stats = yaml.safe_load(f)
            return self._stats

        train = self.dataset.split("train")
        E = self.dataset.num_entities()
        edges = train[:, [0, 2]].astype(np.int64)
        core = core_numbers(E, edges)
        max_core = int(core.max())
        self.config.log(
            f"k-core decomposition: max core = {max_core}"
        )
        rng = np.random.default_rng(seed)
        os.makedirs(self.subsets_folder, exist_ok=True)
        stats: List[Dict] = []
        for k in range(1, max_core + 1):
            keep_entity = core >= k
            if keep_entity.sum() < 2:
                break
            # triples whose endpoints are both in the core
            mask = keep_entity[train[:, 0]] & keep_entity[train[:, 2]]
            sub_triples = train[mask]
            if len(sub_triples) < 10:
                break
            stats.append(
                self._write_subset(k, sub_triples, keep_entity, rng,
                                   valid_frac, valid_max)
            )
        with open(self.stats_file(), "w") as f:
            yaml.dump(stats, f)
        self._stats = stats
        return stats

    def _write_subset(self, k, sub_triples, keep_entity, rng,
                      valid_frac, valid_max) -> Dict:
        folder = os.path.join(self.subsets_folder, f"{k}-core")
        os.makedirs(folder, exist_ok=True)

        # reindex entities and relations densely
        old_entities = np.nonzero(keep_entity)[0]
        ent_map = -np.ones(self.dataset.num_entities(), dtype=np.int64)
        ent_map[old_entities] = np.arange(len(old_entities))
        old_relations = np.unique(sub_triples[:, 1])
        rel_map = -np.ones(self.dataset.num_relations(), dtype=np.int64)
        rel_map[old_relations] = np.arange(len(old_relations))
        re_triples = np.stack(
            [ent_map[sub_triples[:, 0]], rel_map[sub_triples[:, 1]],
             ent_map[sub_triples[:, 2]]], axis=1,
        )

        # fresh train/valid split (original valid likely contains entities
        # absent from the subgraph, reference search_grash intro)
        n = len(re_triples)
        n_valid = int(min(valid_frac * n, valid_max))
        perm = rng.permutation(n)
        valid_triples = re_triples[perm[:n_valid]]
        train_triples = re_triples[perm[n_valid:]]

        for name, arr in (("train", train_triples), ("valid", valid_triples),
                          ("test", valid_triples[:0])):
            np.savetxt(os.path.join(folder, f"{name}.del"), arr,
                       fmt="%d", delimiter="\t")
        entity_ids = self.dataset.entity_ids()
        relation_ids = self.dataset.relation_ids()
        with open(os.path.join(folder, "entity_ids.del"), "w") as f:
            for new, old in enumerate(old_entities):
                f.write(f"{new}\t{entity_ids[int(old)]}\n")
        with open(os.path.join(folder, "relation_ids.del"), "w") as f:
            for new, old in enumerate(old_relations):
                f.write(f"{new}\t{relation_ids[int(old)]}\n")
        name = f"{self.dataset.config.get('dataset.name')}-{k}-core"
        with open(os.path.join(folder, "dataset.yaml"), "w") as f:
            yaml.dump({"dataset": {
                "name": name,
                "num_entities": int(len(old_entities)),
                "num_relations": int(len(old_relations)),
            }}, f)
        train_total = len(self.dataset.split("train"))
        return {
            "k": int(k),
            "folder": folder,
            "num_entities": int(len(old_entities)),
            "num_relations": int(len(old_relations)),
            "num_train": int(len(train_triples)),
            "relative_triples": float(len(re_triples) / train_total),
            "relative_entities": float(
                len(old_entities) / self.dataset.num_entities()
            ),
        }
