from .backend import default_device, resolve_backend
from .preprocessing import (FeatureAnalysis, analyze_features,
                            compute_recip_ranges, detect_discrete_features)
from .validation import resolve_n_features_to_select

__all__ = [
    "default_device",
    "resolve_backend",
    "FeatureAnalysis",
    "analyze_features",
    "compute_recip_ranges",
    "detect_discrete_features",
    "resolve_n_features_to_select",
]
