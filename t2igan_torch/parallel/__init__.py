"""Parallelism of the port (``t2igan.parallel``): data parallelism over
``torch.distributed`` (:mod:`.mesh`) and Megatron-style tensor parallelism
of the CLIP towers (:mod:`.tp`)."""

from t2igan_torch.parallel.mesh import (DataMesh, init_distributed,
                                        ranks_for_batch, spawn_local)

__all__ = ["DataMesh", "init_distributed", "ranks_for_batch", "spawn_local"]
