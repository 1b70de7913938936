"""Shared parameter-validation helpers.

Reproduces the int/float ``n_features_to_select`` contract shared by the
reference estimators (``MultiSURF.py:349-366``, ``ReliefF.py:318-333``,
``SURF.py:295-310``): a float must lie in (0, 1] and selects
``max(1, int(frac * n_features))``; an int must lie in (0, n_features].
"""

from __future__ import annotations


def resolve_n_features_to_select(value, n_features: int) -> int:
    if isinstance(value, bool):
        raise TypeError("n_features_to_select must be an int or a float.")
    if isinstance(value, float):
        if not 0.0 < value <= 1.0:
            raise ValueError(
                "If n_features_to_select is a float, it must be in (0, 1]."
            )
        return max(1, int(value * n_features))
    if isinstance(value, int):
        if not 0 < value <= n_features:
            raise ValueError(
                f"If n_features_to_select is an int ({value}), "
                f"it must be > 0 and <= n_features ({n_features})."
            )
        return int(value)
    raise TypeError("n_features_to_select must be an int or a float.")


def check_min_samples(n_samples: int, name: str) -> None:
    if n_samples < 2:
        raise ValueError(
            f"{name} requires at least 2 samples, but got n_samples = {n_samples}"
        )
