"""Generators repeat bit for bit for a seed, and draw what they claim."""

import numpy as np
import pytest
import torch

from portbench import harness
from portbench.data import generate

SNP = dict(harness.load_cell("snp-paper.multisurf").config,
           n_samples=120, n_features=300, phenotypes=3)
LARGE_N = dict(harness.load_cell("large-n.relieff").config,
               n_samples=500, n_features=30)
BIG_SEED = 2**31 + 12345


@pytest.mark.parametrize("config", [SNP, LARGE_N], ids=["snp", "large-n"])
@pytest.mark.parametrize("seed", [0, BIG_SEED])
def test_same_seed_same_data(config, seed):
    a, b = generate(config, seed, "cpu"), generate(config, seed, "cpu")
    c = generate(config, seed + 7, "cpu")
    assert len(a.variants) == len(b.variants) > 1
    for (xa, ya), (xb, yb), (xc, _) in zip(a.variants, b.variants,
                                           c.variants):
        assert np.array_equal(np.asarray(xa), np.asarray(xb))
        assert np.array_equal(ya, yb)
        assert not np.array_equal(np.asarray(xa), np.asarray(xc))


def test_genotypes_planted_and_balanced():
    d = generate(SNP, 5, "cpu")
    x = d.variants[0][0]
    assert x.dtype == torch.int8 and tuple(x.shape) == (120, 300)
    assert int(x.min()) == 0 and int(x.max()) == 2
    assert all(v[0] is x for v in d.variants)      # one X, phenotypes vary
    for (_, y), cols in zip(d.variants, d.planted):
        assert y.sum() == 60
        share = (x[:, cols[0]].numpy() == y).mean()
        assert share > 0.55    # the strongest planted SNP follows y


def test_classification_matches_scikit_learn():
    datasets = pytest.importorskip("sklearn.datasets")
    from portbench.generators.classification import random_state
    d = generate(LARGE_N, 11, "cpu")
    for k, (x, y) in enumerate(d.variants):
        xs, ys = datasets.make_classification(
            n_samples=500, n_features=30, n_informative=5,
            random_state=random_state(11, k))
        assert np.array_equal(x, xs) and np.array_equal(y, ys)


def test_input_forms():
    d = generate(SNP, 1, "cpu")
    host = d.as_input("host", "cpu")
    x = host.variants[0][0]
    assert isinstance(x, np.ndarray) and x.flags.c_contiguous
    assert all(v[0] is x for v in host.variants)
    dev = generate(LARGE_N, 1, "cpu").as_input("cuda", "cpu")
    assert isinstance(dev.variants[0][0], torch.Tensor)
