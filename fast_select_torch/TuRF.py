"""Reference submodule path ``fast_select.TuRF``."""

from fastselect_tpu_torch.models.turf import TuRF

__all__ = ["TuRF"]
