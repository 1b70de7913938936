"""Multi-device layouts of the Relief engines, MDR, chi2 and the pairwise
statistic matrices, over a mesh of ``torch.device``s.

Counterpart of ``fastselect_tpu/parallel``: ``devices=`` takes a mesh
(:func:`make_mesh`).  In one process a mesh is that process's devices (by
default every visible CUDA device; a device may repeat).  In a process
group of several (``distributed.initialize()``, e.g. under ``torchrun``)
``make_mesh()`` spans every process's devices, and every layout's psum,
all_gather and ppermute cross processes through ``torch.distributed``
(NCCL for CUDA tensors, gloo through pinned host memory): every process
calls the same function with the same inputs and returns the whole
result.  The estimators take these layouts by themselves when the mesh of
``ops/relief.py:_mesh_devices`` has more than one device (several visible
CUDA devices, or a group of processes), unless ``FS_NO_AUTO_SHARD=1``.
"""

from .feature_shard import (feature_sharded_relief_discrete_scores,
                            sharded_chi2_stats)
from .mdr_shard import (ShardedMDRFoldScorer,
                        sharded_batch_balanced_accuracy)
from .ring import ring_relief_discrete_scores
from .sharded import (Mesh, make_mesh, sharded_multisurf_scores,
                      sharded_relief_discrete_scores, sharded_relief_scores)

__all__ = ["sharded_relief_scores", "sharded_multisurf_scores",
           "sharded_relief_discrete_scores",
           "ring_relief_discrete_scores",
           "feature_sharded_relief_discrete_scores",
           "sharded_chi2_stats",
           "sharded_batch_balanced_accuracy", "ShardedMDRFoldScorer",
           "Mesh", "make_mesh"]
