"""Data generators, one module a kind, found by a configuration's
``generator`` key.  Each has ``make(config, seed, device) -> Data``."""
