from .chi2_op import chi2_stats, chi2_stats_exact
from .relief import pair_weight_rules, relief_scores
from .relief_cuda import accumulate, dist_matrix, relief_fused_scores
from .relief_discrete import encode_discrete, relief_discrete_scores
from .relief_hybrid import relief_hybrid_scores

__all__ = ["chi2_stats", "chi2_stats_exact", "pair_weight_rules",
           "relief_scores", "accumulate", "dist_matrix",
           "relief_fused_scores", "encode_discrete",
           "relief_discrete_scores", "relief_hybrid_scores"]
