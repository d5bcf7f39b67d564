"""The device mesh over ranks of ``torch.distributed`` (the port of
kge_tpu/parallel): parallel/distributed.py brings the ranks up,
parallel/mesh.py lays them out as the (data, model) mesh. kge_tpu's ring
schedule (parallel/ring.py) is not ported yet (ROADMAP A.10)."""

from kge_tpu_torch.parallel.mesh import DeviceCtx

__all__ = ["DeviceCtx"]
