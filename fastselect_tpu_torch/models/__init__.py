from .cfs import CFS
from .chi2 import chi2
from .mdr import MDR
from .mrmr import mRMR
from .multisurf import MultiSURF
from .relieff import ReliefF
from .surf import SURF
from .turf import TuRF

__all__ = ["ReliefF", "SURF", "MultiSURF", "TuRF", "mRMR", "chi2", "MDR",
           "CFS"]
