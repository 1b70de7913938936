from . import contingency, mi
from .chi2_op import chi2_stats, chi2_stats_exact
from .contingency import (StagedColumnStats, feature_target_tables,
                          pair_tables, pairwise_stat_columns,
                          pairwise_stat_matrix, pairwise_stat_matrix_device)
from .mdr_op import MDRFoldScorer, batch_balanced_accuracy, unrank_combos
from .mi import (calculate_mi_matrices, calculate_mi_relevance,
                 calculate_mi_single_pair)
from .relief import pair_weight_rules, relief_scores
from .relief_cuda import accumulate, dist_matrix, relief_fused_scores
from .relief_discrete import encode_discrete, relief_discrete_scores
from .relief_hybrid import relief_hybrid_scores

__all__ = ["contingency", "mi", "chi2_stats", "chi2_stats_exact",
           "StagedColumnStats", "feature_target_tables", "pair_tables",
           "pairwise_stat_columns", "pairwise_stat_matrix",
           "pairwise_stat_matrix_device", "calculate_mi_matrices",
           "calculate_mi_relevance", "calculate_mi_single_pair",
           "pair_weight_rules", "relief_scores", "accumulate",
           "dist_matrix", "relief_fused_scores", "encode_discrete",
           "relief_discrete_scores", "relief_hybrid_scores",
           "MDRFoldScorer", "batch_balanced_accuracy", "unrank_combos"]
