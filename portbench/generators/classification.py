"""``sklearn.datasets.make_classification``, drawn as scikit-learn draws
it, in numpy alone (the card's host has no scikit-learn).

The same ``RandomState`` draws in the same order as scikit-learn 1.x with
no repeated features, the hypercube on, no shift or scale, and shuffling
on.  Variant d is the dataset of the ``random_state`` that
``numpy.random.SeedSequence([seed, d])`` gives, so that nearby seeds share
no dataset; every variant has the same shape and so the same work.
"""

from __future__ import annotations

import numpy as np

from ..data import Data


def _sample_without_replacement(n_population, n_samples, rng):
    """sklearn.utils.random.sample_without_replacement, method 'auto'."""
    ratio = n_samples / n_population if n_population else 1.0
    if 0.01 < ratio < 0.99:
        return rng.permutation(n_population)[:n_samples]
    out = np.empty(n_samples, np.int64)
    if ratio < 0.2:   # tracking selection
        selected = set()
        for i in range(n_samples):
            j = rng.randint(n_population)
            while j in selected:
                j = rng.randint(n_population)
            selected.add(j)
            out[i] = j
        return out
    out[:] = np.arange(n_samples)   # reservoir sampling
    for i in range(n_samples, n_population):
        j = rng.randint(0, i + 1)
        if j < n_samples:
            out[j] = i
    return out


def _hypercube(samples, dimensions, rng):
    if dimensions > 30:
        return np.hstack([rng.randint(2, size=(samples, dimensions - 30)),
                          _hypercube(samples, 30, rng)])
    out = _sample_without_replacement(2 ** dimensions, samples, rng)
    out = out.astype(">u4", copy=False)
    return np.unpackbits(out.view(">u1")).reshape((-1, 32))[:, -dimensions:]


def make_classification(n_samples, n_features, *, n_informative,
                        n_redundant, n_classes, n_clusters_per_class,
                        flip_y, class_sep, random_state):
    rng = np.random.RandomState(random_state)
    n_random = n_features - n_informative - n_redundant
    n_clusters = n_classes * n_clusters_per_class
    per_cluster = [int(n_samples * (1.0 / n_classes) / n_clusters_per_class)
                   for _ in range(n_clusters)]
    for i in range(n_samples - sum(per_cluster)):
        per_cluster[i % n_clusters] += 1
    X = np.zeros((n_samples, n_features))
    y = np.zeros(n_samples, dtype=int)
    centroids = _hypercube(n_clusters, n_informative, rng).astype(float)
    centroids *= 2 * class_sep
    centroids -= class_sep
    X[:, :n_informative] = rng.standard_normal(size=(n_samples, n_informative))
    stop = 0
    for k, centroid in enumerate(centroids):
        start, stop = stop, stop + per_cluster[k]
        y[start:stop] = k % n_classes
        X_k = X[start:stop, :n_informative]
        A = 2 * rng.uniform(size=(n_informative, n_informative)) - 1
        X_k[...] = np.dot(X_k, A)
        X_k += centroid
    if n_redundant > 0:
        B = 2 * rng.uniform(size=(n_informative, n_redundant)) - 1
        X[:, n_informative:n_informative + n_redundant] = np.dot(
            X[:, :n_informative], B)
    if n_random > 0:
        X[:, -n_random:] = rng.standard_normal(size=(n_samples, n_random))
    flip = rng.uniform(size=n_samples) < flip_y
    y[flip] = rng.randint(n_classes, size=flip.sum())
    order = np.arange(n_samples)
    rng.shuffle(order)
    X, y = X[order], y[order]
    cols = np.arange(n_features)
    rng.shuffle(cols)
    X[:, :] = X[:, cols]
    return X, y


def random_state(seed: int, variant: int) -> int:
    """The ``random_state`` of variant ``variant`` under ``--seed``."""
    return int(np.random.SeedSequence([int(seed), variant]).generate_state(1)[0])


def make(config: dict, seed: int, device=None) -> Data:
    kw = {k: config[k] for k in ("n_informative", "n_redundant", "n_classes",
                                 "n_clusters_per_class", "flip_y",
                                 "class_sep")}
    variants = [make_classification(int(config["n_samples"]),
                                    int(config["n_features"]),
                                    random_state=random_state(seed, d), **kw)
                for d in range(int(config["datasets"]))]
    return Data(variants)
