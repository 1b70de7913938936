#!/usr/bin/env python3
"""ReliefF fits of one or more source trees on one GPU, in turns.

    python3 tools/relieff_rule_ab.py PARENT . . PARENT

Each argument is the root of a checkout of this repository (this one, or
another commit unpacked with ``git archive``), so that two versions of
ReliefF's weight rule can be timed in one call.  Each runs in a process
of its own, in the order given, on the inputs of this tree's
``chip_smoke.py``:

* large-n: 50,000 x 100 continuous (``make_classification``,
  ``random_state=0``), k = 10: the fused engine's continuous kernels;
* tier-v1: phase 8's 3,000 x 5,000 genotypes, 3 classes, k = 5;
* mixed-fused: phase 6's 2,000 x 200 input with a 150-state column
  (``discrete_limit=200``): the ``MIXED`` kernels;
* tier-v2: 30,000 x 2,048 planted genotypes, 3 classes, k = 10;
* snp-headline: phase 7's 16,384 x 65,536 int8 genotypes, k = 10;
* gwas-gather: phase 24's 8,192 x 5,000,000 genotypes drawn on the card
  into packed codes, scored by ``relief_discrete_scores`` (ReliefF,
  k = 10) through the v2-gather route.

Every fit but gwas-gather's is ``ReliefF(...).fit`` timed first and twice
warm (gwas-gather's once: its packed codes are drawn once), with its peak
device memory, then once under ``utils.profiling.trace`` with the weight
rule (``ops/relief.py:_rules_relieff``) in a ``record_function`` range,
for the rule's device time.  The scores of each input must be equal across
all turns bit for bit.  Prints the card's name and power limit, one line
a turn and input; the last line is one JSON object with every number.
"""

from __future__ import annotations

import importlib.util
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parents[1]
OUT = HERE / "build" / "relieff_rule_ab"
CASES = ("large-n", "tier-v1", "mixed-fused", "tier-v2", "snp-headline",
         "gwas-gather")


def _chip_smoke():
    """This tree's ``chip_smoke.py`` as a module.  Its package imports
    resolve to whichever tree is first on ``sys.path``."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _inputs(cs):
    """(label, make(), X, y) of each estimator fit."""
    from fastselect_tpu_torch import ReliefF
    X, y = cs.make_classification(n_samples=50000, n_features=100,
                                  n_informative=10, random_state=0)
    yield ("large-n", lambda: ReliefF(n_features_to_select=10,
                                      n_neighbors=10),
           X.astype(np.float32), y)
    X, y = cs.planted_genotypes(1, 3000, 5000, 3)
    yield ("tier-v1", lambda: ReliefF(n_features_to_select=3, n_neighbors=5),
           X, y)
    X, y = cs.make_classification(n_samples=2000, n_features=200,
                                  n_informative=10, random_state=1)
    X = X.astype(np.float32)
    X[:, :40] = np.random.RandomState(3).randint(0, 3, (2000, 40))
    X[:, 0] = 2 * y
    X[:, 1] = np.arange(2000) % 150
    yield ("mixed-fused", lambda: ReliefF(n_features_to_select=10,
                                          discrete_limit=200), X, y)
    X, y = cs.planted_genotypes(2, 30000, 2048, 3)
    yield ("tier-v2", lambda: ReliefF(n_features_to_select=3,
                                      n_neighbors=10), X, y)
    rs = np.random.RandomState(0)
    X = rs.randint(0, 3, (16384, 65536), dtype=np.int8)
    y = rs.randint(0, 2, 16384)
    X[:, 0] = 2 * y
    yield ("snp-headline", lambda: ReliefF(n_features_to_select=10,
                                           n_neighbors=10), X, y)


def _fits(cs, dev, label, make, X, y, warm=2):
    import torch
    from fastselect_tpu_torch.ops import relief_discrete as rd
    y_enc = np.unique(y, return_inverse=True)[1]
    cp = (np.bincount(y_enc) / len(y_enc)).astype(np.float32)
    tier = (rd.discrete_tier(*X.shape, 3, y_enc, "relieff", cp, device=dev)
            if X.dtype == np.int8 else "fused")
    times, peaks = [], []
    for _ in range(1 + warm):
        est, sec, peak = cs.timed_fit(dev, make(), X, y)
        times.append(sec)
        peaks.append(peak)
    rules, device_s = cs.rules_device_s(make, X, y,
                                        OUT / f"trace-{label}")
    torch.cuda.empty_cache()
    return est.feature_importances_, dict(
        tier=tier, first_s=times[0], warm_s=times[1:], peak_gb=max(peaks),
        rules_s=rules, fit_device_s=device_s)


def _gather(cs, dev, n=8192, p=5_000_000, seed=25, chunk_rows=256):
    """Phase 24's gwas-gather genotypes, scored once as ReliefF (k = 10)."""
    import torch
    from fastselect_tpu_torch.ops import relief_discrete as rd
    y = cs.balanced_labels(n, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    y_dev = torch.as_tensor(2 * y, dtype=torch.int8, device=dev)

    def chunks():
        for r0 in range(0, n, chunk_rows):
            c = torch.randint(0, 3, (min(chunk_rows, n - r0), p),
                              generator=gen, device=dev, dtype=torch.int8)
            c[:, 0] = y_dev[r0:r0 + c.shape[0]]
            yield c

    pk = rd.stage_codes_packed(chunks(), 3, dev, shape=(n, p))
    cp = np.full(2, 0.5, np.float32)
    tier = rd.discrete_tier(n, p, 3, y, "relieff", cp, device=dev,
                            source="packed")
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    s = rd.relief_discrete_scores(None, y, algo="relieff", n_neighbors=10,
                                  class_probs=cp, codes=pk, n_states=3)
    torch.cuda.synchronize()
    sec = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev) / 1e9
    del pk
    torch.cuda.empty_cache()
    if int(np.argmax(s)) != 0:
        raise RuntimeError("gwas-gather: column 0 does not rank first")
    return s, dict(tier=tier, first_s=sec, warm_s=[], peak_gb=peak)


def _run_tree(root: str, turn: int) -> dict:
    """Fits of the tree at ``root``; scores saved under OUT/<turn>/."""
    import torch
    sys.path[:0] = [root, str(HERE)]
    from fastselect_tpu_torch.ops import relief as relief_mod
    if not Path(relief_mod.__file__).resolve().is_relative_to(
            Path(root).resolve()):
        raise RuntimeError(f"imported {relief_mod.__file__}, not from {root}")
    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    torch.ones(1, device=dev)   # the allocator's statistics exist from here
    torch.backends.cuda.matmul.allow_tf32 = False
    out_dir = OUT / str(turn)
    out_dir.mkdir(parents=True, exist_ok=True)
    rows = {}
    for label, make, X, y in _inputs(cs):
        s, rows[label] = _fits(cs, dev, label, make, X, y)
        np.save(out_dir / f"{label}.npy", s)
        del X
    s, rows["gwas-gather"] = _gather(cs, dev)
    np.save(out_dir / "gwas-gather.npy", s)
    return dict(root=root, rows=rows)


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print("RESULT " + json.dumps(_run_tree(argv[1], int(argv[2]))),
              flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("relieff_rule_ab: no CUDA device is available")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    results = []
    for turn, root in enumerate(argv):
        proc = subprocess.run([sys.executable, __file__, "--one", root,
                               str(turn)], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{root}: rc {proc.returncode}\n"
                               f"{proc.stdout[-4000:]}{proc.stderr[-8000:]}")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("RESULT "))
        res = json.loads(line[len("RESULT "):])
        res["turn"] = turn
        results.append(res)
        for label, r in res["rows"].items():
            rule = (f"; rule's device time {r['rules_s']:.4f} s of the "
                    f"fit's {r['fit_device_s']:.4f} s" if "rules_s" in r
                    else "")
            print(f"turn {turn} {root}: {label} ({r['tier']}): fit "
                  f"{r['first_s']:.4f} s, warm "
                  f"{', '.join(f'{t:.4f}' for t in r['warm_s'])} s; peak "
                  f"{r['peak_gb']:.2f} GB{rule}", flush=True)
    equal = {}
    for label in CASES:
        s = [np.load(OUT / str(t) / f"{label}.npy")
             for t in range(len(argv))]
        equal[label] = all(np.array_equal(a.view(np.int32),
                                          s[0].view(np.int32)) for a in s)
        diff = max(float(np.abs(a - s[0]).max()) for a in s)
        print(f"{label}: scores of every turn equal bit for bit: "
              f"{equal[label]} (max diff {diff:.3e})", flush=True)
    print(json.dumps({"device": smi, "results": results,
                      "bit_equal": equal}), flush=True)
    return 0 if all(equal.values()) else 1


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
