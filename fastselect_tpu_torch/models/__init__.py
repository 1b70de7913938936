from .multisurf import MultiSURF

__all__ = ["MultiSURF"]
