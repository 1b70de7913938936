"""Reference submodule path ``fast_select.MDR``.

The reference test-suite imports ``MAX_K_FOR_KERNEL`` from here
(reference ``tests/test_mdr.py:11``, constant at ``MDR.py:16-17``).
"""

from fastselect_tpu_torch.models.mdr import MAX_K_FOR_KERNEL, MDR

__all__ = ["MDR", "MAX_K_FOR_KERNEL"]
