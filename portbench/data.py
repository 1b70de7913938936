"""A cell's inputs: the variants its fits take in turn."""

from __future__ import annotations

import importlib
from dataclasses import dataclass, field

import numpy as np
import torch


@dataclass
class Data:
    """``variants[v]`` is (X, y) of variant v: X a host array or a tensor
    (variants may share one X), y a host array of labels."""
    variants: list
    planted: list = field(default_factory=list)

    def as_input(self, form: str, device) -> "Data":
        """The variants with X as the mix's input form: ``'host'`` (a
        C-contiguous numpy array) or ``'cuda'`` (a tensor on ``device``);
        a shared X is converted once, and the original is dropped."""
        done = {}
        out = []
        for x, y in self.variants:
            if id(x) not in done:
                done[id(x)] = _convert(x, form, device)
            out.append((done[id(x)], y))
        return Data(out, self.planted)


def _convert(x, form: str, device):
    if form == "host":
        return (np.ascontiguousarray(x.cpu().numpy())
                if isinstance(x, torch.Tensor) else np.ascontiguousarray(x))
    if form == "cuda":
        return torch.as_tensor(x).to(device)
    raise ValueError(f"unknown input form {form!r}")


def generate(config: dict, seed: int, device) -> Data:
    """The configuration's data from ``--seed``, by its ``generator``."""
    mod = importlib.import_module(f"portbench.generators.{config['generator']}")
    return mod.make(config, seed, device)
