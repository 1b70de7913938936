"""Reference submodule path ``fast_select.mutual_information``."""

from fastselect_tpu_torch.mutual_information import (
    calculate_mi_matrices, calculate_mi_single_pair)

__all__ = ["calculate_mi_single_pair", "calculate_mi_matrices"]
