"""Negative sampling on the host.

A copy of kge_tpu/ops/sampler.py (a re-design of the reference sampler,
kge/util/sampler.py), which is plain numpy: sampling and filtering run
host-side, and every product is a *fixed-shape* array. Dynamic quantities
like the number of distinct shared samples are resolved into padded arrays
plus gather maps on the host, so the device computation never changes
shape. Training jobs take this route under ``negative_sampling.on_device:
never`` and whenever positives are filtered.

Differs from kge_tpu's file in one place: batch-level filtering
(``_filter_and_resample_fast``) keeps the numpy route only; kge_tpu's
native C++ filter is not ported.
"""

from __future__ import annotations

import random
from typing import NamedTuple, Optional

import numpy as np

from kge_tpu_torch.config import Config, Configurable
from kge_tpu_torch.dataset import Dataset
from kge_tpu_torch.indexing import where_in

S, P, O = 0, 1, 2
SLOT_STR = ["s", "p", "o"]


class NegativeBatch(NamedTuple):
    """Fixed-shape negative sample of one batch for one slot.

    kind "plain": ``samples`` is [n, num] sampled indexes.
    kind "shared": ``unique_samples`` is [num+1] padded unique indexes and
    ``gather_map`` is [n, num] of column positions into the per-row score
    matrix over ``unique_samples`` (drop-index and repeat logic prebaked).
    """

    slot: int
    num_samples: int
    kind: str
    samples: Optional[np.ndarray] = None
    unique_samples: Optional[np.ndarray] = None
    gather_map: Optional[np.ndarray] = None

    def materialized_samples(self) -> np.ndarray:
        """Negative sample indexes as [n, num] (for tests/inspection)."""
        if self.kind == "plain":
            return self.samples
        return self.unique_samples[self.gather_map]


class KgeSampler(Configurable):
    """Configurable negative sampler (reference sampler.py:16-137)."""

    def __init__(self, config: Config, configuration_key: str, dataset: Dataset):
        super().__init__(config, configuration_key)
        self.dataset = dataset
        self.num_samples = np.zeros(3, dtype=np.int64)
        self.filter_positives = np.zeros(3, dtype=bool)
        self.vocabulary_size = np.array(
            [dataset.num_entities(), dataset.num_relations(), dataset.num_entities()],
            dtype=np.int64,
        )
        self.shared = self.get_option("shared")
        self.shared_type = self.check_option("shared_type", ["naive", "default"])
        self.with_replacement = self.get_option("with_replacement")
        if not self.with_replacement and not self.shared:
            raise ValueError(
                "Without-replacement sampling is only supported when "
                "shared negative sampling is enabled."
            )
        self.filtering_split = config.get("negative_sampling.filtering.split")
        if self.filtering_split == "":
            self.filtering_split = config.get("train.split")
        for slot in [S, P, O]:
            slot_str = SLOT_STR[slot]
            self.num_samples[slot] = self.get_option(f"num_samples.{slot_str}")
            self.filter_positives[slot] = self.get_option(f"filtering.{slot_str}")
            # prebuild the indexes needed for filtering
            if self.filter_positives[slot]:
                pair = ["po", "so", "sp"][slot]
                dataset.index(
                    f"{self.filtering_split}_{pair}_to_{slot_str}"
                )
        if self.filter_positives.any() and self.shared:
            raise ValueError(
                "Filtering is not supported when shared negative sampling "
                "is enabled."
            )
        # -1 means: copy the subject setting (sampler.py:59-64)
        for slot in [P, O]:
            if self.num_samples[slot] == -1:
                self.num_samples[slot] = self.num_samples[S]
        self._rng = np.random.default_rng()
        self._py_rng = random.Random()

    def seed(self, seed: int):
        self._rng = np.random.default_rng(seed)
        self._py_rng = random.Random(seed ^ 0x5EED)

    @staticmethod
    def create(config: Config, configuration_key: str, dataset: Dataset):
        sampling_type = config.get(configuration_key + ".sampling_type")
        if sampling_type == "uniform":
            return KgeUniformSampler(config, configuration_key, dataset)
        elif sampling_type == "frequency":
            return KgeFrequencySampler(config, configuration_key, dataset)
        raise ValueError(f"{configuration_key}.sampling_type={sampling_type}")

    # -- main entry point ------------------------------------------------------

    def sample(
        self, positive_triples: np.ndarray, slot: int,
        num_samples: Optional[int] = None,
    ) -> NegativeBatch:
        """Obtain negatives for the given slot of each positive triple."""
        if num_samples is None:
            num_samples = int(self.num_samples[slot])
        if self.shared:
            return self._sample_shared(positive_triples, slot, num_samples)
        samples = self._sample(positive_triples, slot, num_samples)
        if self.filter_positives[slot]:
            implementation = self.get_option("filtering.implementation")
            if implementation in ("fast", "fast_if_available"):
                samples = self._filter_and_resample_fast(
                    samples, slot, positive_triples
                )
            else:
                samples = self._filter_and_resample(
                    samples, slot, positive_triples
                )
        return NegativeBatch(
            slot=slot, num_samples=num_samples, kind="plain", samples=samples
        )

    def _sample(self, positive_triples, slot, num_samples) -> np.ndarray:
        raise NotImplementedError

    def _sample_shared(self, positive_triples, slot, num_samples) -> NegativeBatch:
        raise NotImplementedError(
            "The selected sampler does not support shared negative samples."
        )

    # -- filtering -------------------------------------------------------------

    def _positives_index(self, slot):
        pair = ["po", "so", "sp"][slot]
        return self.dataset.index(
            f"{self.filtering_split}_{pair}_to_{SLOT_STR[slot]}"
        )

    def _filter_and_resample(self, negative_samples, slot, positive_triples):
        """Per-row resampling loop (reference "standard", sampler.py:163-196)."""
        index = self._positives_index(slot)
        cols = [[P, O], [S, O], [S, P]][slot]
        pairs = positive_triples[:, cols]
        for i in range(len(positive_triples)):
            positives = index.get(int(pairs[i, 0]), int(pairs[i, 1]))
            resample_idx = where_in(negative_samples[i], positives)
            num_new = len(resample_idx)
            num_found = 0
            while num_found < num_new:
                new_samples = self._sample(
                    positive_triples[i : i + 1], slot, num_new - num_found
                ).reshape(-1)
                tn_idx = where_in(new_samples, positives, not_in=True)
                if len(tn_idx):
                    take = new_samples[tn_idx]
                    negative_samples[
                        i, resample_idx[num_found : num_found + len(take)]
                    ] = take
                    num_found += len(take)
        return negative_samples

    def _filter_and_resample_fast(self, negative_samples, slot, positive_triples):
        """Batch-level filtering: find all sample positions that collide with
        a known positive and resample them until clean, in whole-batch
        numpy passes."""
        index = self._positives_index(slot)
        cols = [[P, O], [S, O], [S, P]][slot]
        pairs = positive_triples[:, cols]
        n, m = negative_samples.shape
        rows_idx = index.lookup_rows(pairs[:, 0], pairs[:, 1])
        keys, offsets, values = index.csr()

        def collision_mask(samples):
            # for each (row, sample): is sample among the row's positives?
            mask = np.zeros((n, m), dtype=bool)
            for i in range(n):
                r = rows_idx[i]
                if r < 0:
                    continue
                pos = values[offsets[r] : offsets[r + 1]]
                mask[i] = np.isin(samples[i], pos)
            return mask

        mask = collision_mask(negative_samples)
        # bounded loop: astronomically unlikely to need many rounds
        for _ in range(100):
            num_bad = int(mask.sum())
            if num_bad == 0:
                break
            rows, colpos = np.nonzero(mask)
            fresh = self._sample_flat(rows, positive_triples, slot)
            negative_samples[rows, colpos] = fresh
            mask = collision_mask(negative_samples)
        return negative_samples

    def _sample_flat(self, rows, positive_triples, slot):
        """Draw one sample per entry of ``rows`` (row index into the batch)."""
        flat = self._sample(positive_triples[rows], slot, 1)
        return flat.reshape(-1)


class KgeUniformSampler(KgeSampler):
    def _sample(self, positive_triples, slot, num_samples):
        return self._rng.integers(
            0, self.vocabulary_size[slot],
            size=(len(positive_triples), num_samples),
        ).astype(np.int64)

    def _sample_shared(self, positive_triples, slot, num_samples) -> NegativeBatch:
        """Shared negative sampling (reference sampler.py:596-698).

        Produces a padded unique-sample array plus a per-row gather map so the
        device-side shapes are static:

        - naive: every row shares the same ``num_samples`` columns (with WR
          repeats drawn from the distinct set);
        - default: one extra sample is drawn; each row drops its own positive
          (or a random column) and the spare takes its place.
        """
        batch_size = len(positive_triples)
        vocab = int(self.vocabulary_size[slot])

        # distinct-count distribution for WR sampling
        if self.with_replacement:
            effective_vocab = vocab if self.shared_type == "naive" else vocab - 1
            num_unique = len(
                np.unique(self._rng.integers(0, effective_vocab, num_samples))
            )
        else:
            num_unique = num_samples

        take = num_unique if self.shared_type == "naive" else num_unique + 1
        unique_samples = np.array(
            self._py_rng.sample(range(vocab), take), dtype=np.int64
        )

        if num_unique != num_samples:
            repeat_indexes = self._rng.integers(
                0, num_unique, num_samples - num_unique
            )
        else:
            repeat_indexes = np.empty(0, dtype=np.int64)

        # pad unique samples to a fixed length (num_samples + 1)
        padded = np.zeros(num_samples + 1, dtype=np.int64)
        padded[:take] = unique_samples

        if self.shared_type == "naive":
            # all rows share the same column order: distinct then repeats
            cols = np.concatenate(
                [np.arange(num_unique, dtype=np.int64), repeat_indexes]
            )
            gather_map = np.broadcast_to(cols, (batch_size, num_samples)).copy()
            return NegativeBatch(
                slot=slot, num_samples=num_samples, kind="shared",
                unique_samples=padded, gather_map=gather_map,
            )

        # default: per-row drop index (position of the row's positive in the
        # sample, else random), replaced by the spare sample (index num_unique)
        positives = positive_triples[:, slot]
        drop_index = self._rng.integers(0, num_unique + 1, batch_size)
        sample_pos = {int(s): j for j, s in enumerate(unique_samples)}
        for i in range(batch_size):
            j = sample_pos.get(int(positives[i]))
            if j is not None:
                drop_index[i] = j

        base = np.broadcast_to(
            np.arange(num_unique, dtype=np.int64), (batch_size, num_unique)
        ).copy()
        # where a row's drop index falls inside the first num_unique columns,
        # that column is served by the spare sample instead
        replace = base == drop_index[:, None]
        base[replace] = num_unique
        if len(repeat_indexes):
            # repeats refer to effective columns, i.e. after drop-replacement
            rep = base[:, :][:, repeat_indexes]
            gather_map = np.concatenate([base, rep], axis=1)
        else:
            gather_map = base
        return NegativeBatch(
            slot=slot, num_samples=num_samples, kind="shared",
            unique_samples=padded, gather_map=gather_map,
        )


class KgeFrequencySampler(KgeSampler):
    """Unigram sampling proportional to smoothed training frequency
    (reference sampler.py:755-793); inverse-CDF sampling per slot."""

    def __init__(self, config, configuration_key, dataset):
        super().__init__(config, configuration_key, dataset)
        alpha = self.get_option("frequency.smoothing")
        self._cdf = []
        train = dataset.split(config.get("train.split"))
        for slot in [S, P, O]:
            counts = np.bincount(
                train[:, slot], minlength=self.vocabulary_size[slot]
            ).astype(np.float64) + alpha
            self._cdf.append(np.cumsum(counts / counts.sum()))

    def _sample(self, positive_triples, slot, num_samples):
        if num_samples is None:
            num_samples = int(self.num_samples[slot])
        u = self._rng.random((len(positive_triples), num_samples))
        return np.searchsorted(self._cdf[slot], u).astype(np.int64)
