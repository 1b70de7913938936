"""Reference submodule path ``fast_select.ReliefF``."""

from fastselect_tpu_torch.models.relieff import ReliefF

__all__ = ["ReliefF"]
