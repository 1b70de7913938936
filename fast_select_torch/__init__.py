"""Drop-in import surface of the upstream reference, on the PyTorch port.

Users of GavinLynch04/FastSelect import ``fast_select`` (reference
``src/fast_select/__init__.py:1-10``), a Numba-CUDA GPU library.  This
package maps that surface (the eight public names and the per-algorithm
submodule paths ``fast_select_torch.MDR``, ``fast_select_torch.Chi2``,
...) onto :mod:`fastselect_tpu_torch`, so code written for the reference
runs on an NVIDIA GPU by renaming one import.  Counterpart of the JAX
package's ``fast_select``; it imports nothing of it.  Unlike that shim,
which has no GPU to run on, ``backend='gpu'`` computes here, as it did
upstream: an alias of ``'cuda'`` (``RuntimeError`` without a CUDA
device).
"""

# through the submodules, as upstream does: importing a submodule binds
# its name on the package, and a class of the same name must win
from .CFS import CFS
from .Chi2 import chi2
from .MDR import MDR
from .mRMR import mRMR
from .MultiSURF import MultiSURF
from .ReliefF import ReliefF
from .SURF import SURF
from .TuRF import TuRF

__all__ = ["ReliefF", "SURF", "MultiSURF", "TuRF", "mRMR", "chi2", "MDR",
           "CFS"]
