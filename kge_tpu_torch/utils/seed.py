"""PRNG seeding and device placement.

Derives per-PRNG seeds from ``random_seed.default`` + the PRNG name (as the
reference does with md5 hashing, kge/util/seed.py), seeds python and numpy,
and returns the seed of the root ``torch.Generator`` that all randomness of
a job is drawn from. ``job.device`` names the device the job's tensors live
on: ``auto`` and ``cuda`` mean the CUDA card (``auto`` on a rank of a run
over several processes: its local rank's card) and fail when there is none;
only an explicit ``cpu`` runs on the host.
"""

from __future__ import annotations

import hashlib
import random
from typing import Optional

import numpy as np
import torch

from kge_tpu_torch.config import Config


def _derived_seed(base: int, name: str) -> int:
    h = int(hashlib.md5(name.encode()).hexdigest(), 16)
    return (base + h) % (2 ** 31)


def check_parallel(config: Config) -> None:
    """Refuse the ``parallel.*`` settings this package cannot honour yet: a
    device mesh larger than the run's processes, with kge_tpu's message
    (kge_tpu/parallel/mesh.py ``DeviceCtx.create``): one process is one
    device, so a mesh above 1 x 1 needs as many ranks
    (parallel/distributed.py); and a parameter or compute dtype other than
    float32, bfloat16 and float16. ``parallel.data: -1`` takes the
    ranks over ``parallel.model``."""
    from kge_tpu_torch.parallel import distributed
    from kge_tpu_torch.utils.dtypes import torch_dtype

    for key in ("parallel.param_dtype", "parallel.compute_dtype"):
        torch_dtype(config, key)
    world = distributed.world_size()
    model = max(int(config.get("parallel.model")), 1)
    data = int(config.get("parallel.data"))
    data = data if data > 0 else max(world // model, 1)
    if data * model > world:
        raise ValueError(
            f"mesh {data}x{model} needs {data * model} devices, have {world}"
        )


def resolve_device(config: Config, local_rank: Optional[int] = None) -> torch.device:
    """The torch device named by ``job.device``; raises when it names the
    card and no card is present. ``auto`` is the card; a rank of a run over
    several processes takes its local rank's card (``local_rank``, by
    default the rank's own: parallel/distributed.py ``card_index``)."""
    from kge_tpu_torch.parallel import distributed

    name = str(config.get("job.device"))
    if name == "cpu":
        return torch.device("cpu")
    auto = name == "auto"
    if auto:
        name = "cuda"
    if not name.startswith("cuda"):
        raise ValueError(
            f"job.device={name!r}: kge_tpu_torch runs on 'auto' (the CUDA "
            "card), 'cuda[:N]' or 'cpu'"
        )
    if not torch.cuda.is_available():
        raise RuntimeError(
            f"job.device={config.get('job.device')!r} needs a CUDA card and "
            "none is available; pass --job.device cpu to run on the host"
        )
    if auto and (distributed.is_multiprocess() or local_rank is not None):
        local = distributed.local_rank() if local_rank is None else local_rank
        return torch.device(
            f"cuda:{distributed.card_index(local, torch.cuda.device_count())}")
    return torch.device(name)


def device_of(config: Config) -> torch.device:
    """The torch device named by ``job.device`` (``resolve_device``), after
    ``check_parallel``."""
    check_parallel(config)
    return resolve_device(config)


def apply_device_config(config: Config) -> torch.device:
    """Resolve ``job.device`` and pin float32 precision on the card: matrix
    products and convolutions run in full float32, never TF32."""
    device = device_of(config)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return device


def seed_from_config(config: Config) -> int:
    """Seed host PRNGs; return the seed for the root torch generator (or a
    random one)."""
    default = config.get("random_seed.default")

    def pick(name: str) -> int:
        explicit = config.get(f"random_seed.{name}")
        if explicit >= 0:
            return explicit
        if default >= 0:
            return _derived_seed(default, name)
        return -1

    py_seed = pick("python")
    if py_seed >= 0:
        random.seed(py_seed)
    np_seed = pick("numpy")
    if np_seed >= 0:
        np.random.seed(np_seed)
    # the key keeps the JAX package's name; both packages derive the same
    # root seed from it
    root_seed = pick("jax")
    if root_seed < 0:
        root_seed = random.randrange(2 ** 31)
    return root_seed


def generator_from_config(config: Config, device=None) -> torch.Generator:
    """A ``torch.Generator`` on ``device`` seeded by :func:`seed_from_config`."""
    generator = torch.Generator(device=device or "cpu")
    generator.manual_seed(seed_from_config(config))
    return generator
