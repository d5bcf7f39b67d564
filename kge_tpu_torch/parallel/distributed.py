"""Runs over several processes on ``torch.distributed``.

The port of kge_tpu/parallel/distributed.py. kge_tpu runs one process per
host that drives every local device; this package runs one process per
rank, each on the one device that ``job.device`` names (``cuda:N`` or
``cpu``; ``auto`` is the card of the rank's local rank, ``card_index``),
which is the torch idiom. Ranks come up from the keys kge_tpu reads:
``parallel.distributed.coordinator_address`` / ``num_processes`` /
``process_id``, or, when the config names no address,
``KGE_COORDINATOR_ADDRESS`` / ``KGE_NUM_PROCESSES`` / ``KGE_PROCESS_ID``;
or, under ``parallel.distributed.auto``, from the launcher's environment
(``detect_launcher``), which overrides both, as kge_tpu's call of
``jax.distributed.initialize()`` without arguments does. They meet at a TCP
store on the coordinator's address (under torchrun's agent store, the
agent's), and ``init_process_group`` runs on that store with the world size
and rank.

The backend is ``nccl`` between distinct cards and ``gloo`` on the CPU.
NCCL refuses two ranks on one card ("Duplicate GPU detected"), so before
the process group comes up every rank publishes its host name and its
card's UUID to the store; where two ranks share a card every rank takes
``gloo``, which takes CUDA tensors for ``all_reduce``, ``all_gather``
and ``broadcast`` (``choose_backend``) but CPU tensors only for ``send``
and ``recv``: the ring's point-to-point steps (``exchange``) stage their
buffers through host memory there. Rank 0 logs the decision and every
rank's device once, when the job's mesh comes up (parallel/mesh.py).

Every collective of the package runs with a timeout (the environment's
``KGE_DISTRIBUTED_TIMEOUT`` seconds, 900 by default), so that a rank that
raised or died makes its peers raise instead of waiting for ever. Every
rank holds the same host data, so kge_tpu's ``make_global`` has no
counterpart.

The ranks agree on the outcome of every training step under
``train.subbatch_auto_tune`` (``agree``; ROADMAP A.12) through the store
they met at, outside the process group: each posts its outcome and waits
for the others' at most ``agreement_timeout()``, a thirtieth of the
collectives' timeout, so that a rank that ran out of memory while its peers
wait in a collective of the step does not wait with them. A rank that
gives up tears the process group down (``end_agreement``), which ends its
peers' pending collective; they then read its outcome from the store.
"""

from __future__ import annotations

import datetime
import os
import re
import socket
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import torch

_initialized = False
#: the backend of the process group, "gloo" or "nccl"; None alone
backend: Optional[str] = None
#: whether two ranks share a card (and so the backend is gloo on the card)
shared_card = False
#: this rank's index among the ranks of its host (0 alone)
_local_rank = 0
#: every rank's (host, device), in rank order; empty alone
placement: List[Tuple[str, str]] = []
#: the store the ranks met at, kept for ``agree`` (None alone)
_store = None
#: whether this process serves the store (rank 0, unless torchrun's agent)
_serves_store = False
#: the number of agreements so far, the same on every rank
_agreements = 0
#: (rank, world size) of the run, kept past a teardown
_place = (0, 1)


class Launch(NamedTuple):
    """Where and as what a process joins a run over several processes."""

    address: str
    num_processes: int
    process_id: int
    #: the rank's index among its host's ranks; None where the launcher
    #: does not say (the ranks' host names in the store then give it)
    local_id: Optional[int] = None
    #: torchrun's agent serves the store at ``address`` already
    agent_store: bool = False


#: jax's coordinator port of Open MPI and SLURM jobs: one in the top 2^12
#: ephemeral ports, from the job's id
_PORT_BASE = 65535 - 2 ** 12 + 1


def _ompi_launch(env) -> Launch:
    """jax's ``OmpiCluster``: the launcher's first IP address in
    ``OMPI_MCA_orte_hnp_uri`` and a port from its job id."""
    uri = env["OMPI_MCA_orte_hnp_uri"]
    port = env.get("JAX_COORDINATOR_PORT")
    if not port:
        # the job id is a multiple of 2^12
        port = str(int(uri.split(".", 1)[0]) // 2 ** 12 % 2 ** 12 + _PORT_BASE)
    found = re.search(r"tcp://(.+?)[,:]|tcp6://\[(.+?)[,\]]", uri)
    if found is None:
        raise RuntimeError(
            "Could not parse coordinator IP address from Open MPI environment.")
    host = next(g for g in found.groups() if g is not None)
    return Launch(f"{host}:{port}", int(env["OMPI_COMM_WORLD_SIZE"]),
                  int(env["OMPI_COMM_WORLD_RANK"]),
                  int(env["OMPI_COMM_WORLD_LOCAL_RANK"]))


def _slurm_launch(env) -> Launch:
    """jax's ``SlurmCluster``: the step's first node (``node001``,
    ``node001,host2``, ``node[001-015],host2``, ``node[001,007-015]``) and a
    port from the job id."""
    port = env.get("JAX_COORDINATOR_PORT") or str(
        int(env["SLURM_JOB_ID"]) % 2 ** 12 + _PORT_BASE)
    nodes = env["SLURM_STEP_NODELIST"]
    cut = next((i for i, ch in enumerate(nodes) if ch in ",["), len(nodes))
    if cut == len(nodes) or nodes[cut] == ",":
        host = nodes[:cut]
    else:
        suffix = nodes[cut + 1:]
        end = next((i for i, ch in enumerate(suffix) if ch in ",-"), None)
        host = nodes[:cut] + suffix[:end]
    return Launch(f"{host}:{port}", int(env["SLURM_NTASKS"]),
                  int(env["SLURM_PROCID"]), int(env["SLURM_LOCALID"]))


def _torchrun_launch(env) -> Launch:
    """torchrun's (and ``torch.distributed``'s env://) variables; under
    ``TORCHELASTIC_USE_AGENT_STORE=True`` the agent serves the store."""
    local = env.get("LOCAL_RANK")
    return Launch(f"{env['MASTER_ADDR']}:{env['MASTER_PORT']}",
                  int(env["WORLD_SIZE"]), int(env["RANK"]),
                  None if local in (None, "") else int(local),
                  env.get("TORCHELASTIC_USE_AGENT_STORE") == "True")


#: the launchers ``parallel.distributed.auto`` recognises, the variables
#: that mark each and its reader, in the order it looks for them: jax's
#: (Open MPI, then SLURM; jax/_src/clusters), with torchrun where jax looks
#: for a TPU pod
LAUNCHERS = (
    ("Open MPI", ("OMPI_MCA_orte_hnp_uri",), _ompi_launch),
    ("SLURM", ("SLURM_JOB_ID", "SLURM_STEP_NODELIST", "SLURM_NTASKS",
               "SLURM_PROCID", "SLURM_LOCALID"), _slurm_launch),
    ("torchrun", ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"),
     _torchrun_launch),
)


def detect_launcher(env=None) -> Launch:
    """The launch described by the first launcher environment of
    ``LAUNCHERS`` present in ``env`` (the process's by default); raises a
    ValueError naming what it looked for where there is none, as
    ``jax.distributed.initialize()`` raises."""
    env = os.environ if env is None else env
    for _, marks, launch in LAUNCHERS:
        if all(mark in env for mark in marks):
            return launch(env)
    looked = "; ".join(f"{name} ({', '.join(marks)})" for name, marks, _ in LAUNCHERS)
    raise ValueError(
        "parallel.distributed.auto: no launcher environment found; looked "
        f"for {looked}")


def timeout() -> datetime.timedelta:
    """The timeout of the rendezvous and of every collective."""
    return datetime.timedelta(
        seconds=float(os.environ.get("KGE_DISTRIBUTED_TIMEOUT", "900")))


def agreement_timeout() -> float:
    """Seconds a rank waits for its peers' outcome of a step (``agree``): a
    thirtieth of ``timeout()``, 30 s by default."""
    return timeout().total_seconds() / 30


def _settings(config) -> Optional[Launch]:
    """The launch as kge_tpu reads it (kge_tpu/parallel/distributed.py
    ``maybe_initialize``): the launcher's environment under
    ``parallel.distributed.auto``, else the coordinator keys, else the
    ``KGE_*`` environment; None where none names a coordinator."""
    if config is not None and config.get("parallel.distributed.auto"):
        return detect_launcher()
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
        return None
    if num_processes is None or process_id is None:
        raise ValueError(
            f"coordinator address {address} given without num_processes "
            "and process_id"
        )
    return Launch(address, int(num_processes), int(process_id))


def card_index(local_rank: int, cards: int) -> int:
    """The card of a rank with ``job.device: auto``: its local rank's,
    modulo the host's cards (local ranks beyond the cards share them)."""
    return local_rank % cards


def local_rank() -> int:
    """This rank's index among the ranks of its host (0 alone)."""
    return _local_rank


def choose_backend(device_type: str, peers: Sequence[Tuple[str, str]]) -> str:
    """The backend for ranks on ``device_type`` whose (host, card UUID)
    pairs are ``peers``: ``gloo`` on the CPU and wherever two ranks share a
    card (NCCL refuses that), ``nccl`` otherwise."""
    if device_type != "cuda":
        return "gloo"
    if len(set(peers)) < len(peers):
        return "gloo"
    return "nccl"


def placement_line() -> Optional[str]:
    """Every rank's host and device, and whether ranks share a card; None
    alone."""
    if not placement:
        return None
    ranks = ", ".join(f"{r}: {host} {device}"
                      for r, (host, device) in enumerate(placement))
    shared = len(set(placement)) < len(placement) and any(
        device.startswith("cuda") for _, device in placement)
    return f"Ranks on devices: {ranks}" + (
        " (local ranks outnumber the cards and share them)" if shared else "")


def maybe_initialize(config=None) -> bool:
    """Bring up the process group when the config or the environment names
    a coordinator; True when this run spans several processes. Safe to call
    again. Runs before seeding and before anything else touches the card."""
    global _initialized, backend, shared_card, _local_rank, placement, _store
    global _serves_store, _place
    if _initialized:
        return is_multiprocess()
    import torch.distributed as dist

    from kge_tpu_torch.utils.seed import resolve_device

    launch = _settings(config)
    _initialized = True
    if launch is None or launch.num_processes <= 1:
        return False
    world, rank = launch.num_processes, launch.process_id
    if not 0 <= rank < world:
        raise ValueError(f"process_id {rank} outside [0, {world})")
    host, _, port = launch.address.rpartition(":")
    if not host or not port.isdigit():
        raise ValueError(
            f"coordinator address {launch.address!r} is not host:port")
    if config is not None:
        resolve_device(config, local_rank=0)  # no card named without one
    store = dist.TCPStore(host, int(port), world,
                          is_master=rank == 0 and not launch.agent_store,
                          timeout=timeout())
    if launch.agent_store:
        # the agent's store outlives a restart of its workers
        store = dist.PrefixStore(
            "kge/" + os.environ.get("TORCHELASTIC_RESTART_COUNT", "0"), store)
    name = socket.gethostname()
    store.set(f"kge_host/{rank}", name)
    hosts = [store.get(f"kge_host/{r}").decode() for r in range(world)]
    _local_rank = (launch.local_id if launch.local_id is not None
                   else sum(1 for h in hosts[:rank] if h == name))
    device = (resolve_device(config, local_rank=_local_rank)
              if config is not None else torch.device("cpu"))
    if device.type == "cuda":
        torch.cuda.set_device(device)
        card = str(torch.cuda.get_device_properties(device).uuid)
    else:
        card = "cpu"
    store.set(f"kge_card/{rank}", f"{card}\t{device}")
    cards = [store.get(f"kge_card/{r}").decode().split("\t", 1)
             for r in range(world)]
    peers = [(h, c) for h, (c, _) in zip(hosts, cards)]
    placement = [(h, d) for h, (_, d) in zip(hosts, cards)]
    backend = choose_backend(device.type, peers)
    dist.init_process_group(backend, store=store, world_size=world, rank=rank,
                            timeout=timeout())
    shared_card = device.type == "cuda" and len(set(peers)) < len(peers)
    _store, _serves_store = store, rank == 0 and not launch.agent_store
    _place = (rank, world)
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


def _agreement_store():
    """The store of ``agree``: the one the ranks met at, or the default
    process group's where another caller brought the group up."""
    global _store, _place
    if _store is None:
        import torch.distributed as dist

        _store = dist.distributed_c10d._get_default_store()
        _place = (dist.get_rank(), dist.get_world_size())
    return _store


def _agreement_keys(number: int) -> List[str]:
    return [f"kge_agree/{number}/{r}" for r in range(_place[1])]


def _posted(keys: List[str]) -> Dict[int, Optional[str]]:
    """{rank: the value it posted at its key, None where there is none}."""
    return {r: _store.get(key).decode() if _store.check([key]) else None
            for r, key in enumerate(keys)}


def agree(outcome: str) -> Dict[int, Optional[str]]:
    """Every rank's outcome of a step, this rank's ``outcome`` among them:
    {rank: outcome}, None for a rank that did not post within
    ``agreement_timeout()``. Four round trips to the store a call (post,
    wait, read, and the removal of this rank's previous post); no
    collective of the process group."""
    global _agreements
    store = _agreement_store()
    _agreements += 1
    keys = _agreement_keys(_agreements)
    rank = _place[0]
    store.set(keys[rank], outcome)
    try:
        store.wait(keys, datetime.timedelta(seconds=agreement_timeout()))
    except RuntimeError:  # a peer did not post in time
        return _posted(keys)
    values = store.multi_get(keys)
    if _agreements > 1:
        # every rank read the previous agreement before it posted this one
        store.delete_key(_agreement_keys(_agreements - 1)[rank])
    return {r: v.decode() for r, v in enumerate(values)}


def peer_outcomes() -> Dict[int, Optional[str]]:
    """The outcomes posted so far for the agreement this rank has not
    reached yet (that of the step it is in), without waiting."""
    _agreement_store()
    return _posted(_agreement_keys(_agreements + 1))


def end_agreement(teardown: bool) -> None:
    """This rank gives up after an agreement: it says so in the store, tears
    the process group down where ``teardown`` (a peer may wait in a
    collective, which then raises), and, where it serves the store, waits
    at most ``agreement_timeout()`` for every rank to say so, so that the
    store outlives its peers' reads of the outcomes."""
    import torch.distributed as dist

    store = _agreement_store()
    keys = [f"kge_agree/end/{r}" for r in range(_place[1])]
    store.set(keys[_place[0]], "1")
    if teardown and dist.is_initialized():
        dist.destroy_process_group()
    if _serves_store:
        try:
            store.wait(keys, datetime.timedelta(seconds=agreement_timeout()))
        except RuntimeError:
            pass


def shutdown() -> None:
    """Leave the process group (at the end of a run or after an error)."""
    global _initialized, backend, shared_card, _local_rank, placement, _store
    global _serves_store, _agreements, _place
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        dist.destroy_process_group()
    _initialized = False
    backend = None
    shared_card = False
    _local_rank = 0
    placement = []
    _store, _serves_store, _agreements, _place = None, False, 0, (0, 1)
