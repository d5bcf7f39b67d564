"""``parallel.distributed.auto``: ranks brought up from the launcher's
environment (kge_tpu_torch/parallel/distributed.py ``detect_launcher``), as
kge_tpu's ``jax.distributed.initialize()`` without arguments finds them.

- On faked Open MPI and SLURM environments, the port's (coordinator
  address, number of processes, process id, local id) equals what jax's
  cluster detection returns (``ClusterEnv.auto_detect_unset_distributed_params``,
  the call ``jax.distributed.initialize()`` makes): Open MPI's TCP and TCP6
  URIs, SLURM's node lists (a plain host, ``node[001-004]``, ``a,b``,
  ``node[001,007-015],host2``), the port from ``JAX_COORDINATOR_PORT``,
  both launchers present (Open MPI wins), and none (both raise).
- torchrun's variables, with and without its agent's store
  (``TORCHELASTIC_USE_AGENT_STORE``), where jax would look for a TPU pod.
- ``job.device: auto`` on a rank: the local rank's card, modulo the cards
  (a pure function here, with no card), and a rank without a card raises.
- Two CPU ranks through the command line under torchrun with only its
  variables and ``--parallel.distributed.auto true``: they train, write one
  folder, and their losses are one process's.
"""

import subprocess
import sys

import numpy as np
import pytest
import torch
from jax._src import clusters
from jax._src import distributed as jax_distributed

from kge_tpu_torch import Config
from kge_tpu_torch.parallel import distributed
from kge_tpu_torch.utils.seed import resolve_device
from tests.test_torch_cli import EXAMPLES_DIR, _entries, _env, _toy_cwd

LAUNCH_VARIABLES = (
    "OMPI_MCA_orte_hnp_uri", "OMPI_COMM_WORLD_SIZE", "OMPI_COMM_WORLD_RANK",
    "OMPI_COMM_WORLD_LOCAL_RANK", "SLURM_JOB_ID", "SLURM_STEP_NODELIST",
    "SLURM_NTASKS", "SLURM_PROCID", "SLURM_LOCALID", "SLURM_STEP_NUM_NODES",
    "MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK", "LOCAL_RANK",
    "TORCHELASTIC_USE_AGENT_STORE", "TORCHELASTIC_RESTART_COUNT",
    "JAX_COORDINATOR_ADDRESS", "JAX_COORDINATOR_PORT", "JAX_LOCAL_DEVICE_IDS",
    "KUBERNETES_SERVICE_HOST", "TPU_SKIP_MDS_QUERY", "TPU_WORKER_HOSTNAMES")

OMPI = {"OMPI_MCA_orte_hnp_uri": "1531576320.0;tcp://10.96.0.1,10.148.0.1,10.108.0.1:34911",
        "OMPI_COMM_WORLD_SIZE": "8", "OMPI_COMM_WORLD_RANK": "5",
        "OMPI_COMM_WORLD_LOCAL_RANK": "1"}
OMPI_TCP6 = {**OMPI, "OMPI_MCA_orte_hnp_uri":
             "1314521088.0;tcp6://[fe80::b9b:ac5d:9cf0:b858,2620:10d:c083:150e::3000:2]:43370"}


def slurm(nodes):
    return {"SLURM_JOB_ID": "123456", "SLURM_STEP_NODELIST": nodes,
            "SLURM_NTASKS": "16", "SLURM_PROCID": "9", "SLURM_LOCALID": "3"}


ENVIRONMENTS = {
    "ompi": OMPI,
    "ompi_tcp6": OMPI_TCP6,
    "ompi_port": {**OMPI, "JAX_COORDINATOR_PORT": "12345"},
    "slurm_host": slurm("node001"),
    "slurm_range": slurm("node[001-004]"),
    "slurm_hosts": slurm("a,b"),
    "slurm_list": slurm("node[001,007-015],host2"),
    "slurm_port": {**slurm("node001"), "JAX_COORDINATOR_PORT": "23456"},
    "ompi_and_slurm": {**slurm("node[001-004]"), **OMPI},
}


@pytest.fixture
def environ(monkeypatch):
    """The launchers' variables cleared; returns a setter for a case's."""
    for name in LAUNCH_VARIABLES:
        monkeypatch.delenv(name, raising=False)

    def set_all(values):
        for name, value in values.items():
            monkeypatch.setenv(name, value)

    return set_all


@pytest.mark.parametrize("case", list(ENVIRONMENTS))
def test_launcher_detected_as_jax_detects_it(environ, case):
    environ(ENVIRONMENTS[case])
    address, count, process_id, local_ids = (
        clusters.ClusterEnv.auto_detect_unset_distributed_params(
            None, None, None, None, None, 300))
    launch = distributed.detect_launcher()
    assert (launch.address, launch.num_processes, launch.process_id,
            [launch.local_id]) == (address, count, process_id, local_ids)
    assert not launch.agent_store


def test_no_launcher_raises_in_both(environ):
    """Neither package runs alone under ``auto`` without a launcher: jax's
    ``initialize`` raises before it touches anything, the port names the
    environments it looked for."""
    with pytest.raises(ValueError, match="coordinator_address should be defined"):
        jax_distributed.global_state.initialize()
    with pytest.raises(ValueError, match="no launcher environment found") as info:
        distributed.detect_launcher()
    for name in ("Open MPI", "SLURM", "torchrun", "OMPI_MCA_orte_hnp_uri",
                 "SLURM_JOB_ID", "MASTER_ADDR"):
        assert name in str(info.value)


@pytest.mark.parametrize("agent", [None, "True", "False"])
def test_torchrun_variables(environ, agent):
    """``MASTER_ADDR:MASTER_PORT``, ``WORLD_SIZE``, ``RANK`` and
    ``LOCAL_RANK``; under the agent's store every rank, rank 0 too, joins
    it as a client."""
    environ({"MASTER_ADDR": "10.1.2.3", "MASTER_PORT": "29500",
             "WORLD_SIZE": "4", "RANK": "2", "LOCAL_RANK": "1",
             **({} if agent is None else {"TORCHELASTIC_USE_AGENT_STORE": agent})})
    assert distributed.detect_launcher() == distributed.Launch(
        "10.1.2.3:29500", 4, 2, 1, agent == "True")


def test_auto_overrides_the_coordinator_keys_and_kge_environment(environ, monkeypatch):
    """As in kge_tpu, ``auto`` takes the launcher's settings over the
    ``parallel.distributed`` keys and ``KGE_*``."""
    environ({"MASTER_ADDR": "h", "MASTER_PORT": "1", "WORLD_SIZE": "3", "RANK": "2"})
    monkeypatch.setenv("KGE_COORDINATOR_ADDRESS", "other:2")
    monkeypatch.setenv("KGE_NUM_PROCESSES", "5")
    monkeypatch.setenv("KGE_PROCESS_ID", "4")
    config = Config()
    config.set("parallel.distributed.coordinator_address", "keys:3")
    config.set("parallel.distributed.num_processes", 7)
    config.set("parallel.distributed.process_id", 6)
    assert distributed._settings(config)[:3] == ("keys:3", 7, 6)
    config.set("parallel.distributed.auto", True)
    assert distributed._settings(config)[:4] == ("h:1", 3, 2, None)


@pytest.mark.parametrize("local,cards,card", [
    (0, 8, 0), (7, 8, 7), (1, 1, 0), (3, 1, 0), (5, 4, 1), (2, 2, 0)])
def test_local_rank_to_card(local, cards, card):
    assert distributed.card_index(local, cards) == card


def test_placement_line_says_where_ranks_share_a_card(monkeypatch):
    monkeypatch.setattr(distributed, "placement",
                        [("h", "cuda:0"), ("h", "cuda:0"), ("g", "cuda:0")])
    line = distributed.placement_line()
    assert line.startswith("Ranks on devices: 0: h cuda:0, 1: h cuda:0, 2: g cuda:0")
    assert "share" in line
    monkeypatch.setattr(distributed, "placement", [("h", "cuda:0"), ("h", "cuda:1")])
    assert "share" not in distributed.placement_line()
    monkeypatch.setattr(distributed, "placement", [])
    assert distributed.placement_line() is None


def test_a_rank_without_a_card_raises():
    """``job.device: auto`` names the rank's card; with none it raises, as
    one process does. ``cpu`` stays the host."""
    if torch.cuda.is_available():
        pytest.skip("this host has a card")
    config = Config()
    config.set("job.device", "auto")
    for local in (None, 1):
        with pytest.raises(RuntimeError, match="needs a CUDA card"):
            resolve_device(config, local_rank=local)
    config.set("job.device", "cpu")
    assert resolve_device(config, local_rank=1) == torch.device("cpu")


def test_two_ranks_under_torchrun_train_as_one_process(tmp_path):
    """``python -m torch.distributed.run --standalone --nproc_per_node 2``
    (the agent's store) with ``--parallel.distributed.auto true`` over a
    data axis of 2: one folder, rank 0's log names both ranks' devices, and
    the epochs' losses are one process's within rtol 1e-4, atol 1e-5."""
    cwd = _toy_cwd(tmp_path)
    config = str(EXAMPLES_DIR / "toy-complex-train.yaml")
    common = ["--job.device", "cpu", "--train.max_epochs", "2",
              "--valid.every", "0"]
    env = {k: v for k, v in _env().items() if k not in LAUNCH_VARIABLES}
    env.update(KGE_DISTRIBUTED_TIMEOUT="60", OMP_NUM_THREADS="1")
    ranks = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc_per_node", "2", "-m", "kge_tpu_torch", "start", config, *common,
         "--parallel.distributed.auto", "true", "--parallel.data", "2",
         "--folder", str(cwd / "ranks")],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=600)
    assert ranks.returncode == 0, ranks.stderr[-4000:]
    alone = subprocess.run(
        [sys.executable, "-m", "kge_tpu_torch", "start", config, *common,
         "--folder", str(cwd / "alone")],
        cwd=str(cwd), env=env, capture_output=True, text=True, timeout=600)
    assert alone.returncode == 0, alone.stderr[-4000:]
    assert (cwd / "ranks" / "checkpoint_00002.pt").exists()
    log = (cwd / "ranks" / "kge.log").read_text()
    assert "Mesh 2x1 (data x model) over 2 processes, backend gloo" in log
    assert "Ranks on devices: 0: " in log and ", 1: " in log
    losses = {name: [e["avg_loss"] for e in _entries(cwd / name, event="epoch_completed")]
              for name in ("ranks", "alone")}
    assert len(losses["ranks"]) == 2
    np.testing.assert_allclose(losses["ranks"], losses["alone"], rtol=1e-4, atol=1e-5)
