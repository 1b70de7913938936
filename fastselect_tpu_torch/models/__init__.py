from .cfs import CFS
from .chi2 import chi2
from .mrmr import mRMR
from .multisurf import MultiSURF
from .relieff import ReliefF
from .surf import SURF
from .turf import TuRF

__all__ = ["MultiSURF", "ReliefF", "SURF", "TuRF", "chi2", "mRMR", "CFS"]
