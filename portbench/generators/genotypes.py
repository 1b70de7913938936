"""Genotype matrices with planted phenotypes, drawn on the card.

X is (n_samples, n_features) int8 with values 0 .. n_states - 1, drawn
uniformly, as ``benchmarks/grids.py:snp_data`` draws them.  Each of the
``phenotypes`` balanced binary labels has ``planted_per_phenotype`` SNPs
of its own: in a share ``planted_shares[k]`` of the rows the k-th equals
the label, so that the top features are well apart from the noise and
from each other.  Every variant shares X and takes one phenotype.

Everything is drawn by one ``torch.Generator`` on ``device`` from the
seed, in a few large calls; the same seed gives the same data on the same
kind of device.
"""

from __future__ import annotations

import torch

from ..data import Data


def make(config: dict, seed: int, device) -> Data:
    device = torch.device(device)
    n, p = int(config["n_samples"]), int(config["n_features"])
    n_states = int(config["n_states"])
    shares = [float(s) for s in config["planted_shares"]]
    per, n_pheno = int(config["planted_per_phenotype"]), int(config["phenotypes"])
    if len(shares) != per or per * n_pheno > p:
        raise ValueError("planted_shares must give one share a planted SNP, "
                         "and the planted SNPs must fit in n_features")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    x = torch.randint(0, n_states, (n, p), generator=gen, dtype=torch.int8,
                      device=device)
    planted = torch.randperm(p, generator=gen, device=device)[:per * n_pheno]
    planted = planted.view(n_pheno, per).cpu()
    ys = []
    for t in range(n_pheno):
        y = torch.zeros(n, dtype=torch.int64, device=device)
        y[torch.randperm(n, generator=gen, device=device)[:n // 2]] = 1
        for k, share in enumerate(shares):
            keep = torch.rand(n, generator=gen, device=device) < share
            col = int(planted[t, k])
            x[:, col] = torch.where(keep, y.to(torch.int8), x[:, col])
        ys.append(y.cpu().numpy())
    return Data([(x, y) for y in ys],
                planted=[[int(c) for c in row] for row in planted])
