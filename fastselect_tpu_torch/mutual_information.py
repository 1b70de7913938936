"""Module-level alias matching the reference package layout
(``fast_select.mutual_information``); counterpart of
``fastselect_tpu/mutual_information.py``."""

from .ops.mi import (_validate_discrete, calculate_mi_matrices,
                     calculate_mi_single_pair)

__all__ = ["calculate_mi_single_pair", "calculate_mi_matrices"]
