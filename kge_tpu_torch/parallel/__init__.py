"""The device mesh over ranks of ``torch.distributed`` (the port of
kge_tpu/parallel): parallel/distributed.py brings the ranks up,
parallel/mesh.py lays them out as the (data, model) mesh, and
parallel/ring.py is kge_tpu's ring schedule of full-vocabulary scoring over
the model axis."""

from kge_tpu_torch.parallel.mesh import DeviceCtx

__all__ = ["DeviceCtx"]
