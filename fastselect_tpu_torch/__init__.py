"""fastselect_tpu_torch: the PyTorch and CUDA port of ``fastselect_tpu``.

The same estimators and sklearn contract as the JAX package, which stays
beside it as the reference.  Plain tensor code is PyTorch; the Pallas
kernels of the JAX package become hand-written CUDA kernels for Hopper
(``csrc/``), built with ``nvcc`` the first time one is launched.

Backends: ``backend='auto'|'cuda'|'gpu'|'cpu'`` (``'gpu'`` is an alias of
``'cuda'``, as in the upstream reference).
"""

from . import mutual_information
from .models.cfs import CFS
from .models.chi2 import chi2
from .models.mdr import MDR
from .models.mrmr import mRMR
from .models.multisurf import MultiSURF
from .models.relieff import ReliefF
from .models.surf import SURF
from .models.turf import TuRF

__all__ = ["ReliefF", "SURF", "MultiSURF", "TuRF", "mRMR", "chi2", "MDR",
           "CFS"]

__version__ = "0.1.0"
