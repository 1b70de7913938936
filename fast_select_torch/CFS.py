"""Reference submodule path ``fast_select.CFS``."""

from fastselect_tpu_torch.models.cfs import CFS

__all__ = ["CFS"]
