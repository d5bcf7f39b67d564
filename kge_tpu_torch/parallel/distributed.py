"""Runs over several processes on ``torch.distributed``.

The port of kge_tpu/parallel/distributed.py. kge_tpu runs one process per
host that drives every local device; this package runs one process per
rank, each on the one device that ``job.device`` names (``cuda:N`` or
``cpu``), which is the torch idiom. Ranks come up from the keys kge_tpu
reads: ``parallel.distributed.coordinator_address`` / ``num_processes`` /
``process_id``, or, when the config names no address,
``KGE_COORDINATOR_ADDRESS`` / ``KGE_NUM_PROCESSES`` / ``KGE_PROCESS_ID``.
They meet at a TCP store on the coordinator's address, and
``init_process_group`` runs on that store with the world size and rank.

The backend is ``nccl`` between distinct cards and ``gloo`` on the CPU.
NCCL refuses two ranks on one card ("Duplicate GPU detected"), so before
the process group comes up every rank publishes its host name and its
card's UUID to the store; where two ranks share a card every rank takes
``gloo``, which takes CUDA tensors for ``all_reduce``, ``all_gather``
and ``broadcast`` (``choose_backend``) but CPU tensors only for ``send``
and ``recv``: the ring's point-to-point steps (``exchange``) stage their
buffers through host memory there. Rank 0 logs the decision once, when the
job's mesh comes up (parallel/mesh.py).

Every collective of the package runs with a timeout (the environment's
``KGE_DISTRIBUTED_TIMEOUT`` seconds, 900 by default), so that a rank that
raised or died makes its peers raise instead of waiting for ever. Every
rank holds the same host data, so kge_tpu's ``make_global`` has no
counterpart.
"""

from __future__ import annotations

import datetime
import os
import socket
from typing import Optional, Sequence, Tuple

import torch

_initialized = False
#: the backend of the process group, "gloo" or "nccl"; None alone
backend: Optional[str] = None
#: whether two ranks share a card (and so the backend is gloo on the card)
shared_card = False


def timeout() -> datetime.timedelta:
    """The timeout of the rendezvous and of every collective."""
    return datetime.timedelta(
        seconds=float(os.environ.get("KGE_DISTRIBUTED_TIMEOUT", "900")))


def _settings(config) -> Tuple[Optional[str], Optional[int], Optional[int]]:
    """(address, number of processes, process id) as kge_tpu reads them
    (kge_tpu/parallel/distributed.py ``maybe_initialize``)."""
    address = num_processes = process_id = None
    if config is not None:
        address = config.get("parallel.distributed.coordinator_address") or None
        num_processes = config.get("parallel.distributed.num_processes")
        process_id = config.get("parallel.distributed.process_id")
        if num_processes in ("", -1):
            num_processes = None
        if process_id in ("", -1):
            process_id = None
    if address is None:
        address = os.environ.get("KGE_COORDINATOR_ADDRESS") or None
        if address:
            num_processes = int(os.environ["KGE_NUM_PROCESSES"])
            process_id = int(os.environ["KGE_PROCESS_ID"])
    if address is None:
        return None, None, None
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator address {address} given without num_processes "
            "and process_id"
        )
    return address, int(num_processes), int(process_id)


def choose_backend(device_type: str, peers: Sequence[Tuple[str, str]]) -> str:
    """The backend for ranks on ``device_type`` whose (host, card UUID)
    pairs are ``peers``: ``gloo`` on the CPU and wherever two ranks share a
    card (NCCL refuses that), ``nccl`` otherwise."""
    if device_type != "cuda":
        return "gloo"
    if len(set(peers)) < len(peers):
        return "gloo"
    return "nccl"


def _device_of(config) -> torch.device:
    from kge_tpu_torch.utils.seed import resolve_device

    return resolve_device(config)


def maybe_initialize(config=None) -> bool:
    """Bring up the process group when the config or the environment names
    a coordinator; True when this run spans several processes. Safe to call
    again. Runs before seeding and before anything else touches the card."""
    global _initialized, backend, shared_card
    if _initialized:
        return is_multiprocess()
    import torch.distributed as dist

    if config is not None:
        from kge_tpu_torch.utils.seed import check_distributed

        check_distributed(config)
    address, world, rank = _settings(config)
    _initialized = True
    if address is None or world is None or world <= 1:
        return False
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside [0, {world})")
    host, _, port = address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"coordinator address {address!r} is not host:port")
    device = _device_of(config) if config is not None else torch.device("cpu")
    store = dist.TCPStore(host, int(port), world, is_master=rank == 0,
                          timeout=timeout())
    if device.type == "cuda":
        torch.cuda.set_device(device)
        card = str(torch.cuda.get_device_properties(device).uuid)
    else:
        card = "cpu"
    store.set(f"kge_card/{rank}", f"{socket.gethostname()}\t{card}")
    peers = [
        tuple(store.get(f"kge_card/{r}").decode().split("\t", 1))
        for r in range(world)
    ]
    backend = choose_backend(device.type, peers)
    dist.init_process_group(backend, store=store, world_size=world, rank=rank,
                            timeout=timeout())
    shared_card = device.type == "cuda" and len(set(peers)) < len(peers)
    return True


def is_multiprocess() -> bool:
    import torch.distributed as dist

    return dist.is_available() and dist.is_initialized() \
        and dist.get_world_size() > 1


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if is_multiprocess() else 1


def process_index() -> int:
    import torch.distributed as dist

    return dist.get_rank() if is_multiprocess() else 0


def is_primary() -> bool:
    return process_index() == 0


def barrier(name: str) -> None:
    """Block until every rank reaches this point (no-op alone). ``name``
    says what waits, for the error when a peer never comes."""
    if not is_multiprocess():
        return
    import torch.distributed as dist

    try:
        # monitored_barrier names the ranks that did not come (gloo only)
        if backend == "gloo":
            dist.monitored_barrier(timeout=timeout())
        else:
            dist.barrier()
    except RuntimeError as e:
        raise RuntimeError(f"barrier {name!r}: {e}") from e


def all_reduce(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Sum ``tensor`` in place over ``group`` (the world by default)."""
    import torch.distributed as dist

    dist.all_reduce(tensor, group=group)
    return tensor


def all_reduce_max(tensor: torch.Tensor, group=None) -> torch.Tensor:
    """Take the elementwise maximum of ``tensor`` in place over ``group``
    (the world by default)."""
    import torch.distributed as dist

    dist.all_reduce(tensor, op=dist.ReduceOp.MAX, group=group)
    return tensor


def exchange(tensor: torch.Tensor, send_to: int, recv_from: int,
             group=None) -> torch.Tensor:
    """Send ``tensor`` to the rank ``send_to`` while receiving one of its
    shape and dtype from the rank ``recv_from`` (global ranks of
    ``group``), as one ``batch_isend_irecv``: a step of a ring. Gloo sends
    and receives CPU tensors only, so under gloo a tensor on the card is
    staged through host memory both ways; that staging is the transport,
    and a failed send or receive raises. Gloo's waits keep the package's
    timeout; NCCL's work runs under the process group's."""
    import torch.distributed as dist

    staged = backend == "gloo" and tensor.device.type != "cpu"
    out = tensor.detach().contiguous()
    if staged:
        out = out.cpu()
    buf = torch.empty_like(out)
    works = dist.batch_isend_irecv([
        dist.P2POp(dist.isend, out, send_to, group),
        dist.P2POp(dist.irecv, buf, recv_from, group),
    ])
    for work in works:
        if backend == "gloo":
            work.wait(timeout())
        else:
            work.wait()
    return buf.to(tensor.device) if staged else buf


def all_gather(piece: torch.Tensor, count: int, group=None) -> torch.Tensor:
    """The ``count`` pieces of ``group`` (the world by default), of one
    shape on every rank, stacked on a new first axis in group-rank order,
    on every rank of the group."""
    if count == 1:
        return piece.unsqueeze(0).clone()
    import torch.distributed as dist

    parts = [torch.empty_like(piece) for _ in range(count)]
    dist.all_gather(parts, piece.contiguous(), group=group)
    return torch.stack(parts)


def fetch(tensor: torch.Tensor) -> torch.Tensor:
    """Every rank's ``tensor`` (of one shape on all ranks), stacked on a
    new first axis in rank order, on every rank."""
    return all_gather(tensor, world_size())


def shutdown() -> None:
    """Leave the process group (at the end of a run or after an error)."""
    global _initialized, backend
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    backend = None
