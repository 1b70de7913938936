from .relief import pair_weight_rules, relief_scores
from .relief_cuda import accumulate, dist_matrix, relief_fused_scores

__all__ = ["pair_weight_rules", "relief_scores", "accumulate",
           "dist_matrix", "relief_fused_scores"]
