"""The check that decides ``correct``: what the timed path produced,
held against the plain reference of ``reference/``.

Each checked fit's ``feature_importances_`` and ``top_features_`` are
compared with the reference's scores for the same X and y:

* ``score_gap``: the widest gap between a score of the program and the
  reference's, over the features and over the checked fits, as a share
  of the reference's largest absolute score;
* ``top_miss``: selected features that are not a valid choice: a
  selected feature whose reference score lies below the reference's
  n_select-th best by more than twice the ``score_gap`` limit (as a
  share of the largest score: scores within the limit of the reference
  can reorder by twice it), a repeat, or a missing pick; at most 0;
* ``fits_checked``: the checked fits, at least 1.

Which variants are checked is drawn from the seed (``variants_checked``
of the cell's limits file); every fit of the window on those variants is
compared.  The limits, the readings they were set from and the control
are in ``limits/<cell>.json``.
"""

from __future__ import annotations

import numpy as np
import torch

from .reference.relief import relief_scores

ALGOS = {"MultiSURF": "multisurf", "ReliefF": "relieff"}


def checked_variants(limits: dict, n_variants: int, seed: int) -> set:
    k = min(n_variants, int(limits.get("variants_checked", n_variants)))
    rng = np.random.default_rng(int(seed))
    return set(int(v) for v in rng.choice(n_variants, size=k, replace=False))


def reference(mix: dict, data, variants, device,
              dtype=torch.float64) -> dict:
    """Reference scores of each variant, one pass a shared X."""
    params = mix.get("params", {})
    groups = {}
    for v in sorted(variants):
        groups.setdefault(id(data.variants[v][0]), []).append(v)
    out = {}
    for vs in groups.values():
        x = data.variants[vs[0]][0]
        scores = relief_scores(
            x, [data.variants[v][1] for v in vs],
            algo=ALGOS[mix["estimator"]],
            n_neighbors=int(params.get("n_neighbors", 10)),
            discrete_limit=int(params.get("discrete_limit", 10)),
            device=device, dtype=dtype)
        out.update(zip(vs, scores))
    return out


def readings(outputs, refs: dict, n_select: int, gap_limit: float) -> dict:
    """(score_gap, top_miss) of ``outputs``: (variant, importances, top)
    against the reference scores ``refs``."""
    gap, miss = 0.0, 0
    for v, imp, top in outputs:
        ref = refs[v]
        scale = float(np.abs(ref).max()) or 1.0
        gap = max(gap, float(np.abs(np.asarray(imp, np.float64) - ref).max())
                  / scale)
        kth = np.sort(ref)[-n_select]
        top = np.asarray(top)
        bad = int((ref[top] < kth - 2 * gap_limit * scale).sum())
        miss = max(miss, bad + n_select - len(set(top.tolist())))
    return {"score_gap": gap, "top_miss": miss}


def compare(cell, data, fits, checked, device) -> dict:
    """The numbers compared for the fits of the window, each beside its
    limit."""
    lim = cell.limits["numbers"]
    outputs = [(f.variant, f.importances, f.top) for f in fits]
    refs = reference(cell.mix, data, checked, device) if outputs else {}
    n_select = int(cell.mix["params"]["n_features_to_select"])
    got = readings(outputs, refs, n_select, lim["score_gap"]["limit"])
    return {
        "score_gap": {"value": got["score_gap"],
                      "limit": lim["score_gap"]["limit"]},
        "top_miss": {"value": got["top_miss"],
                     "limit": lim["top_miss"]["limit"]},
        "fits_checked": {"value": len(outputs), "at_least": 1},
    }


def passes(numbers: dict) -> bool:
    for name, num in numbers.items():
        if "limit" in num and not num["value"] <= num["limit"]:
            return False
        if "at_least" in num and not num["value"] >= num["at_least"]:
            return False
    return True


def lines(numbers: dict) -> list[str]:
    """One plain line a number compared: name, value, limit."""
    out = []
    for name, num in numbers.items():
        bound = (f"limit {num['limit']!r}" if "limit" in num
                 else f"at least {num['at_least']!r}")
        out.append(f"check {name} {num['value']!r} {bound}")
    return out
