"""Reference submodule path ``fast_select.MultiSURF``."""

from fastselect_tpu_torch.models.multisurf import MultiSURF

__all__ = ["MultiSURF"]
