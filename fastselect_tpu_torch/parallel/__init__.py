"""Multi-device layouts of the Relief engines, MDR, chi2 and the pairwise
statistic matrices, over a mesh of ``torch.device``s in one process.

Counterpart of ``fastselect_tpu/parallel``: ``devices=`` takes a mesh
(:func:`make_mesh`, by default every visible CUDA device; a device may
repeat).  The estimators take these layouts by themselves when more than
one CUDA device is visible (``ops/relief.py:_mesh_devices``), unless
``FS_NO_AUTO_SHARD=1``.
"""

from .feature_shard import (feature_sharded_relief_discrete_scores,
                            sharded_chi2_stats)
from .mdr_shard import (ShardedMDRFoldScorer,
                        sharded_batch_balanced_accuracy)
from .ring import ring_relief_discrete_scores
from .sharded import (make_mesh, sharded_multisurf_scores,
                      sharded_relief_discrete_scores, sharded_relief_scores)

__all__ = ["sharded_relief_scores", "sharded_multisurf_scores",
           "sharded_relief_discrete_scores",
           "ring_relief_discrete_scores",
           "feature_sharded_relief_discrete_scores",
           "sharded_chi2_stats",
           "sharded_batch_balanced_accuracy", "ShardedMDRFoldScorer",
           "make_mesh"]
