"""The plain reference against a brute-force loop and against the port,
at tiny sizes on the CPU."""

import numpy as np
import pytest
import torch

from portbench.reference.relief import relief_scores


def brute(x, y, algo, k=10):
    """The upstream semantics, one focal row at a time, float64."""
    x = np.asarray(x, np.float64)
    n, p = x.shape
    disc = np.array([len(np.unique(x[:, f])) <= 10 for f in range(p)])
    rng = x.max(0) - x.min(0)
    rng[rng == 0] = 1
    diff = lambda i: np.where(disc, x[i] != x, np.abs(x[i] - x) / rng)  # noqa
    classes, y = np.unique(y, return_inverse=True)
    prior = np.bincount(y) / n
    out = np.zeros(p)
    for i in range(n):
        d = diff(i)
        D = d.sum(1)
        others = np.arange(n) != i
        if algo == "multisurf":
            t = D[others].mean() - D[others].std() / 2
            near = (D < t) & others
            hit, miss = near & (y == y[i]), near & (y != y[i])
            out -= d[hit].sum(0) / max(hit.sum(), 1)
            out += d[miss].sum(0) / max(miss.sum(), 1)
        else:
            order = [j for j in np.argsort(D, kind="stable") if j != i]
            hits = [j for j in order if y[j] == y[i]][:k]
            if hits:
                out -= d[hits].sum(0) / len(hits)
            for c in range(len(classes)):
                if c != y[i]:
                    m = [j for j in order if y[j] == c][:k]
                    den = 1 - prior[y[i]] or 1.0
                    out += prior[c] / den * d[m].sum(0) / k
    return out / n


def data(kind, seed, n=90, p=24):
    rs = np.random.RandomState(seed)
    y = rs.randint(0, 3 if kind == "disc3" else 2, n)
    if kind.startswith("disc"):
        x = rs.randint(0, 3, (n, p)).astype(np.int8)
        x[:, 0] = np.where(rs.rand(n) < 0.6, y % 3, x[:, 0])
    else:
        x = rs.randn(n, p)
        x[:, 0] += y
    return x, y


@pytest.mark.parametrize("algo", ["multisurf", "relieff"])
@pytest.mark.parametrize("kind", ["disc", "disc3", "cont"])
def test_reference_equals_brute_force(algo, kind):
    x, y = data(kind, 3)
    got = relief_scores(x, [y], algo=algo, n_neighbors=10)[0]
    np.testing.assert_allclose(got, brute(x, y, algo), rtol=1e-9,
                               atol=1e-12)


def test_several_label_vectors_share_one_pass():
    x, y = data("disc", 4)
    y2 = np.random.RandomState(9).randint(0, 2, len(y))
    both = relief_scores(x, [y, y2], algo="multisurf")
    for yy, got in zip([y, y2], both):
        np.testing.assert_array_equal(
            got, relief_scores(x, [yy], algo="multisurf")[0])


@pytest.mark.parametrize("algo", ["multisurf", "relieff"])
@pytest.mark.parametrize("kind", ["disc", "cont"])
def test_reference_agrees_with_the_port(algo, kind):
    from fastselect_tpu_torch import MultiSURF, ReliefF
    x, y = data(kind, 5, n=200, p=40)
    est = (MultiSURF(n_features_to_select=5, backend="cpu")
           if algo == "multisurf" else
           ReliefF(n_features_to_select=5, n_neighbors=10, backend="cpu"))
    port = est.fit(x, y).feature_importances_
    ref = relief_scores(x, [y], algo=algo, n_neighbors=10)[0]
    assert np.abs(port - ref).max() <= 1e-5 * np.abs(ref).max()


def test_lower_precision_moves_the_scores():
    x, y = data("disc", 6, n=200, p=40)
    ref = relief_scores(x, [y], algo="multisurf")[0]
    low = relief_scores(x, [y], algo="multisurf", dtype=torch.bfloat16)[0]
    assert np.abs(low - ref).max() > 1e-3 * np.abs(ref).max()


def test_mixed_data_is_refused():
    x, y = data("cont", 1)
    x[:, 3] = np.round(x[:, 3]) % 2
    with pytest.raises(NotImplementedError):
        relief_scores(x, [y], algo="multisurf")
