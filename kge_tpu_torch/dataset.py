"""Dataset container and loaders.

Fresh implementation of the reference data layer (kge/dataset.py): lazy
loading of triple splits (tab-separated ``.del`` files of dense int indexes),
id/string maps, named derived indexes, and a binary cache next to the data
files for fast reloading. The cache files of this package carry a ``.torch``
infix: the JAX package's caches pickle its own classes, and loading them
here would import it.
"""

from __future__ import annotations

import os
import pickle
import tempfile
import uuid
from typing import Any, Callable, Dict, List, Optional

import numpy as np

from kge_tpu_torch import misc, native
from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.indexing import create_default_index_functions


class Dataset(Configurable):
    """Stores information about a dataset.

    Holds the splits (Nx3 int32 triple arrays), index->string maps for
    entities and relations, and derived indexes (lazily computed and cached
    via :meth:`index`).
    """

    #: abort when a stale binary cache is detected instead of recomputing
    _abort_when_cache_outdated = False

    def __init__(self, config: Config, folder: Optional[str] = None):
        super().__init__(config, "dataset")
        self.folder = folder

        try:
            self._num_entities: Optional[int] = self.get_option("num_entities")
            if self._num_entities < 0:
                self._num_entities = None
        except KeyError:
            self._num_entities = None

        try:
            self._num_relations: Optional[int] = self.get_option("num_relations")
            if self._num_relations < 0:
                self._num_relations = None
        except KeyError:
            self._num_relations = None

        #: loaded splits, by key (e.g. "train")
        self._triples: Dict[str, np.ndarray] = {}
        #: loaded maps, by key (e.g. "entity_ids")
        self._meta: Dict[str, Any] = {}
        #: derived indexes, by name
        self._indexes: Dict[str, Any] = {}
        #: registered index functions, by name
        self.index_functions: Dict[str, Callable] = {}
        create_default_index_functions(self)

    # -- LOADING --------------------------------------------------------------

    def ensure_available(self, key: str):
        if self.folder is None or not os.path.exists(self.folder):
            raise IOError(
                "Dataset folder {} not found".format(self.folder)
            )
        filename = self.config.get(f"dataset.files.{key}.filename")
        if not os.path.exists(os.path.join(self.folder, filename)):
            raise IOError(
                "File {} for dataset key {} could not be found".format(
                    filename, key
                )
            )

    @staticmethod
    def create(config: Config, preload_data: bool = True, folder: Optional[str] = None):
        """Load the dataset configured under ``dataset.name``.

        Resolves ``data/<name>/dataset.yaml`` relative to the current working
        directory, the repository root, and any registered module roots, and
        merges it into the configuration.
        """
        name = config.get("dataset.name")
        root_modules = list(config.get("modules"))
        from_dir = config.get_default("dataset.from_dir")
        if folder is None and from_dir:
            folder = Dataset._ingest_from_dir(config, from_dir)
        if folder is None:
            candidates = [
                os.path.join(os.getcwd(), "data", name),
                os.path.join(misc.kge_base_dir(), "..", "data", name),
            ]
            for m in root_modules:
                try:
                    candidates.append(os.path.join(misc.module_base_dir(m), "data", name))
                except ModuleNotFoundError:
                    pass
            for candidate in candidates:
                if os.path.isfile(os.path.join(candidate, "dataset.yaml")):
                    folder = candidate
                    break
            if folder is None:
                folder = candidates[0]

        config_path = os.path.join(folder, "dataset.yaml")
        if os.path.isfile(config_path):
            config.log("Loading configuration of dataset " + name + "...")
            config.load(config_path, create=True)

        dataset = Dataset(config, folder)
        if preload_data:
            dataset.entity_ids()
            dataset.relation_ids()
            for split in ["train", "valid", "test"]:
                dataset.split(split)
        return dataset

    @staticmethod
    def _ingest_from_dir(config: Config, from_dir: str) -> str:
        """Resolve ``dataset.from_dir``: an explicit directory holding the
        dataset — either already in framework format (``dataset.yaml``
        present) or the published raw layout (``train.txt``/``valid.txt``/
        ``test.txt``), which is preprocessed in place on first use. With
        ``dataset.from_dir_checksum`` set, the raw split files must match
        the given sha256 (computed over train/valid/test contents in that
        order) — a zero-trust gate for reproducing published numbers on
        mounted data (e.g. the FB15k-237 quality gate, examples/
        fb15k-237-complex-1vsall.yaml) without any downloader."""
        import hashlib

        if not os.path.isdir(from_dir):
            raise IOError(f"dataset.from_dir {from_dir} is not a directory")
        raw = [
            os.path.join(from_dir, f)
            for f in ("train.txt", "valid.txt", "test.txt")
        ]
        expected = config.get_default("dataset.from_dir_checksum")
        preprocessed = os.path.isfile(os.path.join(from_dir, "dataset.yaml"))
        stamp = os.path.join(from_dir, ".from_dir_verified")
        if expected:
            missing = [p for p in raw if not os.path.isfile(p)]
            if missing:
                # raw splits absent: only a recorded verification of THIS
                # digest keeps the zero-trust property — dataset.yaml alone
                # proves nothing about the data's provenance
                recorded = None
                if os.path.isfile(stamp):
                    with open(stamp) as f:
                        recorded = f.read().strip()
                if preprocessed and recorded == expected:
                    config.log(
                        "dataset.from_dir raw splits are gone; ingest was "
                        "previously verified against this checksum"
                    )
                else:
                    raise IOError(
                        "dataset.from_dir_checksum set but raw split files "
                        "are missing (and no matching verification stamp): "
                        f"{', '.join(os.path.basename(m) for m in missing)}"
                    )
            else:
                h = hashlib.sha256()
                for path in raw:
                    with open(path, "rb") as f:
                        h.update(f.read())
                digest = h.hexdigest()
                if digest != expected:
                    raise ValueError(
                        f"dataset.from_dir checksum mismatch: expected "
                        f"{expected}, got {digest}"
                    )
                config.log(
                    f"dataset.from_dir checksum verified ({digest[:12]}...)"
                )
                try:
                    with open(stamp, "w") as f:
                        f.write(digest)
                except OSError:
                    pass  # read-only mount: verification just reruns
        if preprocessed:
            return from_dir
        if all(os.path.isfile(p) for p in raw):
            from kge_tpu_torch.data.preprocess import preprocess_default

            config.log(f"Preprocessing raw splits in {from_dir} ...")
            preprocess_default(from_dir)
            return from_dir
        raise IOError(
            f"dataset.from_dir {from_dir} holds neither dataset.yaml nor "
            "raw train/valid/test.txt splits"
        )

    @staticmethod
    def create_from(
        checkpoint: Dict,
        config: Config = None,
        dataset: Optional["Dataset"] = None,
        preload_data: bool = False,
    ) -> "Dataset":
        """Create/update a dataset from a checkpoint (e.g. a packaged model)."""
        if config is None:
            config = Config.create_from(checkpoint)
        if dataset is None:
            dataset = Dataset.create(config, preload_data)
        if "dataset" in checkpoint:
            dataset_checkpoint = checkpoint["dataset"]
            if "dataset.meta" in dataset_checkpoint:
                dataset._meta.update(dataset_checkpoint["dataset.meta"])
            dataset._num_entities = dataset_checkpoint["dataset.num_entities"]
            dataset._num_relations = dataset_checkpoint["dataset.num_relations"]
        return dataset

    def save_to(self, checkpoint: Dict, meta_keys: Optional[List[str]] = None) -> Dict:
        """Adds the dataset caches (sizes, optional metadata) to a checkpoint."""
        checkpoint["dataset"] = {
            "dataset.num_entities": self.num_entities(),
            "dataset.num_relations": self.num_relations(),
        }
        if meta_keys:
            meta = {}
            for key in meta_keys:
                meta[key] = self.map_indexes(None, key)
            checkpoint["dataset"]["dataset.meta"] = meta
        return checkpoint

    # -- binary cache ---------------------------------------------------------

    def _cache_filename(self, name: str) -> Optional[str]:
        if self.folder is None:
            return None
        return os.path.join(self.folder, f"{name}.torch.kgecache")

    def _sources_mtime(self) -> float:
        here = os.path.dirname(os.path.abspath(__file__))
        mtimes = []
        for f in ("dataset.py", "indexing.py"):
            p = os.path.join(here, f)
            if os.path.exists(p):
                mtimes.append(os.path.getmtime(p))
        return max(mtimes) if mtimes else 0.0

    def _cache_load_if_uptodate(self, name: str, data_files: List[str]):
        """Load cache ``name`` if newer than data files and framework sources."""
        cache_file = self._cache_filename(name)
        if cache_file is None or not os.path.exists(cache_file):
            return None
        if not self.get_option("pickle"):
            return None
        cache_mtime = os.path.getmtime(cache_file)
        deps = [os.path.join(self.folder, f) for f in data_files]
        for dep in deps:
            if os.path.exists(dep) and os.path.getmtime(dep) > cache_mtime:
                if Dataset._abort_when_cache_outdated:
                    raise ValueError(f"cache file {cache_file} is outdated")
                return None
        if self._sources_mtime() > cache_mtime:
            if Dataset._abort_when_cache_outdated:
                raise ValueError(f"cache file {cache_file} is outdated")
            return None
        with open(cache_file, "rb") as f:
            return pickle.load(f)

    def _cache_dump_atomic(self, obj, name: str):
        cache_file = self._cache_filename(name)
        if cache_file is None or not self.get_option("pickle"):
            return
        tmpfile = cache_file + f".tmp-{uuid.uuid4().hex[:8]}"
        try:
            with open(tmpfile, "wb") as f:
                pickle.dump(obj, f, protocol=pickle.HIGHEST_PROTOCOL)
            os.replace(tmpfile, cache_file)
        except OSError:
            pass  # cache is an optimization only; ignore readonly folders
        finally:
            if os.path.exists(tmpfile):
                try:
                    os.remove(tmpfile)
                except OSError:
                    pass

    # -- low-level file loading ----------------------------------------------

    def load_triples(self, key: str) -> np.ndarray:
        """Load or retrieve the triples with the specified key."""
        if key not in self._triples:
            self.ensure_available(key)
            filename = self.config.get(f"dataset.files.{key}.filename")
            filetype = self.config.get(f"dataset.files.{key}.type")
            if filetype != "triples":
                raise ValueError(
                    f"Unexpected file type: dataset.files.{key}.type='{filetype}', "
                    "expected 'triples'"
                )
            triples = self._cache_load_if_uptodate(f"triples-{key}", [filename])
            if triples is None:
                triples = Dataset._load_triples_file(
                    os.path.join(self.folder, filename)
                )
                self._cache_dump_atomic(triples, f"triples-{key}")
                self.config.log(f"Loaded {len(triples)} {key} triples")
            else:
                self.config.log(f"Loaded {len(triples)} {key} triples (cached)")
            self._triples[key] = triples
        return self._triples[key]

    @staticmethod
    def _load_triples_file(filename: str, delimiter: str = "\t") -> np.ndarray:
        """An [N, 3] int32 array of a triple file. With a tab (or no)
        delimiter, the grammar of ``native.parse_triples``: integers
        separated by spaces or tabs, columns after the third ignored, blank
        lines skipped, a malformed line a ValueError; the library parses
        where it is built, else its numpy version. Any other delimiter
        splits each line on it and takes the first three columns."""
        if os.path.getsize(filename) == 0:
            return np.empty((0, 3), dtype=np.int32)
        if delimiter in ("\t", None):
            triples = native.parse_triples(filename)
            if triples is None:
                triples = native.parse_triples_numpy(filename)
            return triples
        rows = []
        with open(filename, "r") as f:
            for number, line in enumerate(f, 1):
                line = line.rstrip("\r\n")
                if not line:
                    continue
                fields = line.split(delimiter)
                if len(fields) < 3:
                    raise ValueError(
                        f"{filename}, line {number}: fewer than 3 columns"
                    )
                rows.append(fields[:3])
        return np.ascontiguousarray(np.array(rows, dtype=np.int32).reshape(-1, 3))

    def load_map(
        self,
        key: str,
        as_list: bool = True,
        maptype: Optional[str] = None,
        ids_key: Optional[str] = None,
        ignore_duplicates: bool = False,
    ):
        """Load or retrieve the map with the specified key.

        When ``as_list``, returns a list positioned by index (else a dict).
        ``maptype`` checks the file type; ``ids_key`` translates an "idmap"
        file (external id -> string) through the ids of ``ids_key``.
        """
        if key not in self._meta:
            self.ensure_available(key)
            filename = self.config.get(f"dataset.files.{key}.filename")
            filetype = self.config.get(f"dataset.files.{key}.type")
            if maptype and filetype != maptype:
                if not ids_key:
                    raise ValueError(
                        f"Unexpected file type: dataset.files.{key}.type="
                        f"'{filetype}', expected {maptype}"
                    )
            if filetype == "idmap" and ids_key:
                ids = self.load_map(ids_key, as_list=True)
                raw = Dataset._load_map_file(
                    os.path.join(self.folder, filename), as_list=False
                )
                result = [raw.get(i, None) for i in ids]
                nones = sum(1 for x in result if x is None)
                if nones > 0:
                    self.config.log(
                        f"Warning: could not find {nones} ids in map file {filename}"
                    )
                self._meta[key] = result
            else:
                cached = self._cache_load_if_uptodate(f"map-{key}", [filename])
                if cached is None:
                    cached = Dataset._load_map_file(
                        os.path.join(self.folder, filename), as_list=True
                    )
                    self._cache_dump_atomic(cached, f"map-{key}")
                self._meta[key] = cached
        result = self._meta[key]
        if as_list:
            if isinstance(result, dict):
                n = max(result.keys()) + 1 if result else 0
                result = [result.get(i, None) for i in range(n)]
            return result
        else:
            if isinstance(result, list):
                return {i: v for i, v in enumerate(result)}
            return result

    @staticmethod
    def _load_map_file(filename: str, as_list: bool = True, delimiter: str = "\t"):
        dictionary = {}
        warned = False
        with open(filename, "r", encoding="utf-8") as f:
            for line in f:
                line = line.rstrip("\n")
                if not line:
                    continue
                parts = line.split(delimiter, 1)
                key = parts[0]
                value = parts[1] if len(parts) > 1 else ""
                if as_list:
                    key = int(key)
                if key in dictionary and not warned:
                    warned = True
                dictionary[key] = value
        if as_list:
            n = max(dictionary.keys()) + 1 if dictionary else 0
            return [dictionary.get(i, None) for i in range(n)]
        return dictionary

    # -- ACCESS ---------------------------------------------------------------

    def files_of_type(self, file_type: str) -> List[str]:
        """Return all keys of files of the given type."""
        files = self.config.get("dataset.files")
        return [k for k, v in files.items() if v.get("type") == file_type]

    def num_entities(self) -> int:
        if self._num_entities is None:
            self._num_entities = len(self.entity_ids())
        return self._num_entities

    def num_relations(self) -> int:
        if self._num_relations is None:
            self._num_relations = len(self.relation_ids())
        return self._num_relations

    def split(self, split: str) -> np.ndarray:
        """Return the triples of the specified split (Nx3 int32)."""
        return self.load_triples(split)

    def entity_ids(self, indexes=None):
        """Decode indexes to entity ids (all when ``indexes`` is None)."""
        return self.map_indexes(indexes, "entity_ids")

    def relation_ids(self, indexes=None):
        return self.map_indexes(indexes, "relation_ids")

    def entity_strings(self, indexes=None):
        result = self.load_map(
            "entity_strings", as_list=True, ids_key="entity_ids", ignore_duplicates=True
        )
        return self._map_indexes(indexes, result)

    def relation_strings(self, indexes=None):
        result = self.load_map(
            "relation_strings", as_list=True, ids_key="relation_ids",
            ignore_duplicates=True,
        )
        return self._map_indexes(indexes, result)

    def meta(self, key: str):
        return self._meta[key]

    @staticmethod
    def _map_indexes(indexes, values):
        if indexes is None:
            return values
        elif isinstance(indexes, (int, np.integer)):
            return values[int(indexes)]
        else:
            arr = np.asarray(indexes)
            flat = [values[int(i)] for i in arr.reshape(-1)]
            return np.array(flat, dtype=object).reshape(arr.shape)

    def map_indexes(self, indexes, key: str):
        """Map indexes to values of map ``key``."""
        map_ = self.load_map(key, as_list=True)
        return Dataset._map_indexes(indexes, map_)

    # -- INDEXES --------------------------------------------------------------

    def index(self, key: str):
        """Return the index with the given name (computing it lazily).

        Index functions write their result into ``self._indexes[key]``. Heavy
        indexes are cached on disk next to the data files.
        """
        if key not in self._indexes:
            cached = None
            # disk cache for KvsAll indexes only (cheap + heavy ones)
            use_disk = "_to_" in key
            if use_disk:
                deps = [
                    self.config.get(f"dataset.files.{split}.filename")
                    for split in self.files_of_type("triples")
                ]
                cached = self._cache_load_if_uptodate(f"index-{key}", deps)
            if cached is not None:
                self._indexes[key] = cached
            else:
                self.index_functions[key](self)
                if use_disk:
                    self._cache_dump_atomic(self._indexes[key], f"index-{key}")
        return self._indexes[key]

    def shallow_copy(self) -> "Dataset":
        """A copy that shares the loaded data and indexes."""
        copy = Dataset(self.config, self.folder)
        copy._num_entities = self.num_entities()
        copy._num_relations = self.num_relations()
        copy._triples = self._triples
        copy._meta = self._meta
        copy._indexes = self._indexes
        copy.index_functions = self.index_functions
        return copy
