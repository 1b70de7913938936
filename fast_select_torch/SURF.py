"""Reference submodule path ``fast_select.SURF``."""

from fastselect_tpu_torch.models.surf import SURF

__all__ = ["SURF"]
