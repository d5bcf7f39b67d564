"""``train.subbatch_auto_tune`` over the ranks of a mesh (ROADMAP A.12) on
the CPU: two gloo ranks over 2 x 1 train a scanned, edge-partitioned epoch
of shared-negative ComplEx on a synthetic graph, with the card's
out-of-memory error injected by patching the job in the rank processes
(tests/torch_mesh.py ``task_auto_tune``), as tests/test_torch_subbatch.py
``_oom_job`` injects one in one process:

- on both ranks before the first write: both halve the subbatch size,
  retry the step with the same draws, and end the epoch equal in every bit
  to a run started at the halved size;
- on one rank after its optimizer's first write, and on one rank alone
  before it (its peer waiting in the step's gradient sum): both ranks end
  with the same ``RanksOutOfMemoryError``, which names A.12, with
  ``train.subbatch_size`` reduced for the resume, the second within a few
  times the agreement's bound (a thirtieth of ``KGE_DISTRIBUTED_TIMEOUT``,
  60 s here) and far within the collectives' own timeout.

One launch of the ranks runs the three cases in this order.
"""

import numpy as np
import pytest

from tests.torch_mesh import launch
from tests.util import make_synthetic_dataset

BATCH = 32
HALVED = 16
OPTIONS = {
    "model": "complex",
    "lookup_embedder.dim": 8,
    "train.type": "negative_sampling",
    "train.batch_size": BATCH,
    "train.loss": "kl",
    "train.optimizer.default.type": "Adagrad",
    "train.optimizer.default.args.lr": 0.1,
    "train.optimizer.default.args.initial_accumulator_value": 0.1,
    "negative_sampling.shared": True,
    "negative_sampling.num_samples.s": 4,
    "negative_sampling.num_samples.o": -1,
    "valid.every": 0,
    "parallel.data": 2,
    "parallel.model": 1,
    "parallel.partition_edges": "auto",
}
TIMEOUT_S = 60  # KGE_DISTRIBUTED_TIMEOUT of the ranks: an agreement waits 2 s


@pytest.fixture(scope="module")
def cases(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("auto_tune_mesh")
    data = make_synthetic_dataset(tmp / "tune_synth", num_entities=32, num_relations=4,
                                  num_train=100, seed=3)
    results = launch({"tasks": [{
        "name": "tune", "kind": "auto_tune", "data": str(data), "halved": HALVED,
        "options": {**OPTIONS, "dataset.name": "tune_synth"},
    }]}, 2, tmp / "ranks", timeout=300,
        env_extra={"KGE_DISTRIBUTED_TIMEOUT": str(TIMEOUT_S)})["tune"]
    return results


def _tables(path):
    arrays = np.load(path)
    return [arrays[k] for k in sorted(arrays.files, key=int)]


def test_out_of_memory_on_every_rank_halves_and_retries(cases):
    for rank, got in enumerate(cases):
        both, halved = got["both"], got["halved"]
        assert both["partition_edges"]
        assert both["error"] is None and halved["error"] is None, both["error"]
        assert both["subbatch_size"] == HALVED
        assert any(f"halving subbatch size to {HALVED} and retrying" in note
                   for note in both["notes"]), both["notes"]
        assert both["loss"] == halved["loss"]
        for a, b in zip(_tables(both["tables"]), _tables(halved["tables"])):
            assert np.array_equal(a.view(np.uint8), b.view(np.uint8))
    assert cases[0]["both"]["loss"] == cases[1]["both"]["loss"]


@pytest.mark.parametrize("case,where", [
    ("after_write", "after the optimizer's first write"),
    ("one_rank", "but not on every rank"),
])
def test_out_of_memory_on_one_rank_ends_every_rank(cases, case, where):
    errors = [got[case]["error"] for got in cases]
    assert errors[0] == errors[1], errors
    assert errors[0].startswith(
        "RanksOutOfMemoryError: device out of memory on rank(s) 1 of the 2x1 mesh "
        f"{where}: the ranks cannot retry the step together (ROADMAP A.12); "
        f"resume from the last checkpoint with train.subbatch_size {HALVED}"), errors
    for got in cases:
        assert got[case]["out_of_memory"]
        assert got[case]["subbatch_size"] == HALVED
        assert any("cannot retry in-process" in note for note in got[case]["notes"])
        # the agreement waits TIMEOUT_S / 30 = 2 s for a peer
        assert got[case]["seconds"] < 10 * TIMEOUT_S / 30, got[case]["seconds"]
