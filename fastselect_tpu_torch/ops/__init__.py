from .relief import pair_weight_rules, relief_scores
from .relief_cuda import accumulate, dist_matrix, relief_fused_scores
from .relief_discrete import encode_discrete, relief_discrete_scores

__all__ = ["pair_weight_rules", "relief_scores", "accumulate",
           "dist_matrix", "relief_fused_scores", "encode_discrete",
           "relief_discrete_scores"]
