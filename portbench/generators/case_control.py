"""Case-control genotype cohorts with planted phenotypes, drawn on the card.

X is (n_samples, n_features) int8 genotypes 0 .. n_states - 1 under
Hardy-Weinberg: each SNP's minor-allele frequency q is drawn from
U(``minor_allele_frequency``), and each genotype is Binomial(n_states -
1, q), a sum of Bernoulli(q) draws.  Each of the ``phenotypes``
case-control labels marks ``n_cases`` samples, drawn anew a phenotype, as
cases (1) and the rest as controls (0), and has ``planted_per_phenotype``
SNPs of its own: in a share ``planted_shares[k]`` of the rows the k-th
equals the label, as ``genotypes`` plants them.  Every variant shares X
and takes one phenotype, so one cohort stays on the card across the trait
fits.

Everything is drawn by one ``torch.Generator`` on ``device`` from the
seed, X a block of rows at a time so that the uniform draws stay small
beside it; the same seed gives the same data on the same kind of device.
"""

from __future__ import annotations

import torch

from ..data import Data

# uniform draws a block of rows of X
_BLOCK_ELEMS = 1 << 26


def make(config: dict, seed: int, device) -> Data:
    device = torch.device(device)
    n, p = int(config["n_samples"]), int(config["n_features"])
    n_cases, n_states = int(config["n_cases"]), int(config["n_states"])
    lo, hi = (float(v) for v in config["minor_allele_frequency"])
    shares = [float(s) for s in config["planted_shares"]]
    per, n_pheno = int(config["planted_per_phenotype"]), int(config["phenotypes"])
    if len(shares) != per or per * n_pheno > p:
        raise ValueError("planted_shares must give one share a planted SNP, "
                         "and the planted SNPs must fit in n_features")
    if not 0 < n_cases < n or not 0 <= lo <= hi <= 1 or n_states < 2:
        raise ValueError("cases and controls must both be present, the "
                         "allele frequencies in [0, 1], and n_states >= 2")
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed))
    q = lo + (hi - lo) * torch.rand(p, generator=gen, device=device)
    x = torch.empty((n, p), dtype=torch.int8, device=device)
    step = max(1, _BLOCK_ELEMS // p)
    for r0 in range(0, n, step):
        rows = x[r0:r0 + step]
        rows.zero_()
        for _ in range(n_states - 1):
            rows += torch.rand(rows.shape, generator=gen, device=device) < q
    planted = torch.randperm(p, generator=gen, device=device)[:per * n_pheno]
    planted = planted.view(n_pheno, per).cpu()
    ys = []
    for t in range(n_pheno):
        y = torch.zeros(n, dtype=torch.int64, device=device)
        y[torch.randperm(n, generator=gen, device=device)[:n_cases]] = 1
        for k, share in enumerate(shares):
            keep = torch.rand(n, generator=gen, device=device) < share
            col = int(planted[t, k])
            x[:, col] = torch.where(keep, y.to(torch.int8), x[:, col])
        ys.append(y.cpu().numpy())
    return Data([(x, y) for y in ys],
                planted=[[int(c) for c in row] for row in planted])
