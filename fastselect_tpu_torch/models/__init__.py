from .multisurf import MultiSURF
from .relieff import ReliefF
from .surf import SURF

__all__ = ["MultiSURF", "ReliefF", "SURF"]
