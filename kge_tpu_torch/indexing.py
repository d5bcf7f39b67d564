"""Dataset indexes.

Array-only re-design of the reference's index layer (kge/indexing.py). The
reference builds a Numba typed-dict from key pairs to rows
(kge/indexing.py:58-73) plus CSR-style offsets; here the whole index is three
numpy arrays (unique sorted keys, CSR offsets, values) and lookups are
vectorized ``np.searchsorted`` over packed int64 keys — no JIT warmup, fully
picklable, and the same CSR representation the filtered evaluation hands to
the rank kernel.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np


_SLOT_NAMES = {0: "s", 1: "p", 2: "o"}
S, P, O = 0, 1, 2


def _empty_int32() -> np.ndarray:
    return np.empty(0, dtype=np.int32)


def _pack_keys(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """Pack two non-negative int32 arrays into one sortable int64 key."""
    return (a.astype(np.int64) << 32) | b.astype(np.int64)


class KvsAllIndex:
    """Maps a key pair (e.g. (s,p)) to all matching values (e.g. all o).

    Semantics match the reference's KvsAllIndex (kge/indexing.py:10-194):
    constructed from a triple set for a (key, value) slot combination; supports
    per-pair lookup and bulk coordinate retrieval.
    """

    def __init__(
        self,
        triples: np.ndarray,
        key_cols: List[int],
        value_col: int,
        default_factory=None,
    ):
        triples = np.asarray(triples)
        self.key_cols = list(key_cols)
        self.value_col = value_col
        self.default_factory = (
            default_factory if default_factory is not None else _empty_int32
        )

        keys_packed = _pack_keys(triples[:, key_cols[0]], triples[:, key_cols[1]])
        order = np.argsort(keys_packed, kind="stable")
        sorted_keys = keys_packed[order]

        # unique keys + CSR offsets into the sorted value array
        unique_keys, start = np.unique(sorted_keys, return_index=True)
        self._keys_packed = unique_keys  # [K] packed int64
        self._keys = np.stack(
            [
                (unique_keys >> 32).astype(np.int32),
                (unique_keys & 0xFFFFFFFF).astype(np.int32),
            ],
            axis=1,
        )  # [K, 2]
        self._values_offset = np.concatenate(
            [start, [len(sorted_keys)]]
        ).astype(np.int64)  # [K+1]
        self._values = triples[order, value_col].astype(np.int32)  # [N]

    def __len__(self) -> int:
        return len(self._keys_packed)

    @property
    def num_keys(self) -> int:
        return len(self._keys_packed)

    def keys(self) -> np.ndarray:
        """All unique key pairs, [K, 2] int32, in packed sort order."""
        return self._keys

    def lookup_rows(self, key1: np.ndarray, key2: np.ndarray) -> np.ndarray:
        """Return index row for each query pair, or -1 when absent."""
        q = _pack_keys(np.asarray(key1), np.asarray(key2))
        if len(self._keys_packed) == 0:
            return np.full(q.shape, -1, dtype=np.int64)
        pos = np.searchsorted(self._keys_packed, q)
        pos = np.minimum(pos, len(self._keys_packed) - 1)
        found = self._keys_packed[pos] == q
        return np.where(found, pos, -1)

    def get(self, key1: int, key2: int) -> np.ndarray:
        """All values for one key pair (empty array when absent)."""
        row = int(self.lookup_rows(np.array([key1]), np.array([key2]))[0])
        if row < 0:
            return self.default_factory()
        lo, hi = self._values_offset[row], self._values_offset[row + 1]
        return self._values[lo:hi]

    def counts(self, rows: np.ndarray) -> np.ndarray:
        """Number of values per index row (0 for row -1)."""
        rows = np.asarray(rows)
        if len(self._keys_packed) == 0:
            return np.zeros(rows.shape, dtype=np.int64)
        safe = np.maximum(rows, 0)
        n = self._values_offset[safe + 1] - self._values_offset[safe]
        return np.where(rows < 0, 0, n)

    def get_all_coords(
        self, key1: np.ndarray, key2: np.ndarray
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Bulk lookup: values of every query pair as coordinate lists.

        Returns (query_rows, values): for query i with values v_1..v_k, emits
        k entries (i, v_j). The reference computes the same coordinate set
        with a numba kernel (kge/indexing.py:114-155); here it is a
        searchsorted plus a repeat.
        """
        rows = self.lookup_rows(key1, key2)
        counts = self.counts(rows)
        query_rows = np.repeat(
            np.arange(len(rows), dtype=np.int64), counts
        )
        # gather the value ranges
        safe = np.maximum(rows, 0)
        starts = self._values_offset[safe]
        total = int(counts.sum())
        if total == 0:
            return query_rows, np.empty(0, dtype=np.int32)
        # vectorized ragged range: for each query, indices start..start+count
        cum = np.concatenate([[0], np.cumsum(counts)])
        flat = np.arange(total, dtype=np.int64)
        within = flat - cum[query_rows]
        value_idx = starts[query_rows] + within
        return query_rows, self._values[value_idx]

    def csr(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Raw CSR representation: (keys [K,2], offsets [K+1], values [N])."""
        return self._keys, self._values_offset, self._values


def where_in(x: np.ndarray, y: np.ndarray, not_in: bool = False) -> np.ndarray:
    """Positions in ``x`` of elements (not) contained in ``y``.

    Vectorized replacement for the reference's numba set-membership filter
    (kge/indexing.py:415-428).
    """
    mask = np.isin(x, y, invert=not_in)
    return np.nonzero(mask)[0]


def index_KvsAll(dataset, split: str, key: str) -> KvsAllIndex:
    """Build (and cache on the dataset) a KvsAll index.

    ``key`` is one of "sp", "po", "so"; value slot is the remaining one.
    """
    value = {"sp": "o", "po": "s", "so": "p"}[key]
    name = f"{split}_{key}_to_{value}"
    if name not in dataset._indexes:
        cols = {"sp": [S, P], "po": [P, O], "so": [S, O]}[key]
        value_col = {"o": O, "s": S, "p": P}[value]
        triples = dataset.split(split)
        dataset._indexes[name] = KvsAllIndex(triples, cols, value_col)
    return dataset._indexes[name]


def index_relation_types(dataset) -> Dict[str, set]:
    """Classify relations as 1-1, 1-N, M-1, M-N (Bordes et al. heuristic).

    A relation is "N"/"M" on a side when the average number of distinct
    values per key exceeds 1.5 (reference kge/indexing.py:238-293).
    """
    if "relation_types" in dataset._indexes:
        return dataset._indexes["relation_types"]
    triples = dataset.split("train")
    relations = triples[:, P]
    num_relations = dataset.num_relations()
    relation_types = {}
    for r in range(num_relations):
        mask = relations == r
        t = triples[mask]
        if len(t) == 0:
            relation_types[r] = "M-N"
            continue
        # avg number of objects per (s,p): count triples / count distinct s
        num_s = len(np.unique(t[:, S]))
        num_o = len(np.unique(t[:, O]))
        avg_o_per_s = len(t) / num_s
        avg_s_per_o = len(t) / num_o
        many_o = avg_o_per_s > 1.5
        many_s = avg_s_per_o > 1.5
        if many_s and many_o:
            relation_types[r] = "M-N"
        elif many_s:
            relation_types[r] = "M-1"
        elif many_o:
            relation_types[r] = "1-N"
        else:
            relation_types[r] = "1-1"
    result = {"1-1": set(), "1-N": set(), "M-1": set(), "M-N": set()}
    for r, t in relation_types.items():
        result[t].add(r)
    dataset._indexes["relation_types"] = result
    return result


def index_relations_per_type(dataset):
    return index_relation_types(dataset)


def index_frequency_percentiles(dataset, recompute: bool = False) -> Dict:
    """Entity/relation frequency quartiles for eval drill-downs.

    Groups subjects, relations, and objects into the 25/50/75/top percentile
    buckets of their train-split frequency (reference kge/indexing.py:296-359).
    """
    if "frequency_percentiles" in dataset._indexes and not recompute:
        return dataset._indexes["frequency_percentiles"]
    triples = dataset.split("train")
    result = {}
    for arg, col, vocab in (
        ("subject", S, dataset.num_entities()),
        ("relation", P, dataset.num_relations()),
        ("object", O, dataset.num_entities()),
    ):
        counts = np.bincount(triples[:, col], minlength=vocab)
        order = np.argsort(counts, kind="stable")
        quartiles = {}
        n = len(order)
        bounds = [0, n // 4, n // 2, (3 * n) // 4, n]
        names = ["25%", "50%", "75%", "top"]
        for i, name in enumerate(names):
            quartiles[name] = set(order[bounds[i] : bounds[i + 1]].tolist())
        result[arg] = quartiles
    dataset._indexes["frequency_percentiles"] = result
    return result


class IndexWrapper:
    """Binds an index function with keyword arguments (for the registry)."""

    def __init__(self, fun, **kwargs):
        self.fun = fun
        self.kwargs = kwargs

    def __call__(self, dataset, **kwargs):
        self.fun(dataset, **self.kwargs)


def _invert_ids(dataset, obj: str):
    """Build <obj>_id_to_index from the <obj>_ids map."""
    if f"{obj}_id_to_index" not in dataset._indexes:
        ids = dataset.load_map(f"{obj}_ids")
        inv = {v: k for k, v in enumerate(ids)}
        dataset._indexes[f"{obj}_id_to_index"] = inv


def create_default_index_functions(dataset) -> None:
    """Register the default index functions on a dataset."""
    for split in dataset.files_of_type("triples"):
        for key, value in [("sp", "o"), ("po", "s"), ("so", "p")]:
            dataset.index_functions[f"{split}_{key}_to_{value}"] = IndexWrapper(
                index_KvsAll, split=split, key=key
            )
    dataset.index_functions["relation_types"] = index_relation_types
    dataset.index_functions["relations_per_type"] = index_relations_per_type
    dataset.index_functions["frequency_percentiles"] = index_frequency_percentiles
    for obj in ["entity", "relation"]:
        dataset.index_functions[f"{obj}_id_to_index"] = IndexWrapper(
            _invert_ids, obj=obj
        )


# make index_KvsAll populate the dataset cache under the canonical name even
# when invoked through the registry
def _index_KvsAll_registry(dataset, split: str, key: str):
    index_KvsAll(dataset, split, key)


index_KvsAll_registry = _index_KvsAll_registry
