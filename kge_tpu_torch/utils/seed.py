"""PRNG seeding and device placement.

Derives per-PRNG seeds from ``random_seed.default`` + the PRNG name (as the
reference does with md5 hashing, kge/util/seed.py), seeds python and numpy,
and returns the seed of the root ``torch.Generator`` that all randomness of
a job is drawn from. ``job.device`` names the device the job's tensors live
on: ``auto`` and ``cuda`` mean the CUDA card and fail when there is none;
only an explicit ``cpu`` runs on the host.
"""

from __future__ import annotations

import hashlib
import random

import numpy as np
import torch

from kge_tpu_torch.config import Config


def _derived_seed(base: int, name: str) -> int:
    h = int(hashlib.md5(name.encode()).hexdigest(), 16)
    return (base + h) % (2 ** 31)


def device_of(config: Config) -> torch.device:
    """The torch device named by ``job.device``; raises when it names the
    card and no card is present."""
    name = str(config.get("job.device"))
    if name == "cpu":
        return torch.device("cpu")
    if name == "auto":
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
    return torch.device(name)


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
