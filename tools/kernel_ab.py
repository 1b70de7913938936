#!/usr/bin/env python3
"""Time the Relief kernels of one or more source trees on one GPU, in turns.

    python3 tools/kernel_ab.py PARENT . . PARENT

Each argument is the root of a checkout of this repository (this one, or
another commit unpacked with ``git archive``).  Each runs in a process of
its own, in the order given: it builds that tree's kernels into its own
``build/kernels/`` and times its four wrappers (``relief_cuda.dist_matrix``
and ``accumulate``, continuous and ``MIXED``) at the shapes that
``chip_smoke.py`` times (``timed_shapes``, planned by this tree), on the
inputs it makes (``random_inputs``), with its ``cuda_ms``: CUDA events,
the mean of 10 launches after one warm-up.  Beside each pass-1 time it
prints a checksum of D (the int64 sum of its bits), which is equal across
trees whose D is bit-equal.  The last line is one JSON object with every
number and the card's name and power limit.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]
REPS = 10


def _chip_smoke():
    """This tree's ``chip_smoke.py`` as a module.  Its package imports
    resolve to whichever tree is first on ``sys.path``."""
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  HERE / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _time_tree(root: str, shapes: list) -> dict:
    """Times and checksums of the kernels of the tree at ``root``."""
    import torch
    sys.path.insert(0, root)
    from fastselect_tpu_torch.ops import relief_cuda as rc
    if not Path(rc.__file__).resolve().is_relative_to(Path(root).resolve()):
        raise RuntimeError(f"imported {rc.__file__}, not from {root}")
    cs = _chip_smoke()
    dev = torch.device("cuda", 0)
    # trees before the MIXED redesign plan pass 2 without the discrete run
    runs_plan = "n_disc" in inspect.signature(rc.accumulate).parameters
    rows = []
    for tag, label, nb, n, p, n_disc, _ in shapes:
        mixed = tag == "mixed"
        xp, recip, disc = cs.random_inputs(dev, n, p, n_disc, seed=2)
        xi = xp[:nb]
        torch.manual_seed(3)
        W = torch.rand(nb, n, device=dev) - 0.5
        kw = {"n_disc": n_disc} if runs_plan and mixed else {}
        D = rc.dist_matrix(xp, recip, disc, xi=xi, mixed=mixed)
        checksum = int(D.view(torch.int32).sum(dtype=torch.int64))
        del D
        ms1 = cs.cuda_ms(lambda: rc.dist_matrix(xp, recip, disc, xi=xi,
                                                mixed=mixed), REPS)
        ms2 = cs.cuda_ms(lambda: rc.accumulate(xp, W, recip, disc, xi=xi,
                                               mixed=mixed, **kw), REPS)
        rows.append(dict(tag=tag, label=label, nb=nb, n=n, p=p,
                         n_disc=n_disc, pass1_ms=ms1, pass2_ms=ms2,
                         d_checksum=checksum))
        del xp, xi, W
        torch.cuda.empty_cache()
    return dict(root=root, rows=rows)


def main(argv: list[str]) -> int:
    if len(argv) == 3 and argv[0] == "--one":
        print("RESULT " + json.dumps(_time_tree(argv[1], json.loads(argv[2]))),
              flush=True)
        return 0
    if not argv:
        raise SystemExit(__doc__)
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("kernel_ab: no CUDA device is available")
    sys.path.insert(0, str(HERE))
    shapes = json.dumps(_chip_smoke().timed_shapes(torch.device("cuda", 0)))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    results = []
    for turn, root in enumerate(argv):
        proc = subprocess.run([sys.executable, __file__, "--one", root,
                               shapes], capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"{root}: rc {proc.returncode}\n"
                               f"{proc.stdout}{proc.stderr}")
        line = next(ln for ln in proc.stdout.splitlines()
                    if ln.startswith("RESULT "))
        res = json.loads(line[len("RESULT "):])
        res["turn"] = turn
        results.append(res)
        for r in res["rows"]:
            print(f"turn {turn} {root}: {r['tag']} {r['label']} "
                  f"{r['nb']}x{r['n']}x{r['p']} ({r['n_disc']} discrete): "
                  f"pass 1 {r['pass1_ms']:.4f} ms (D checksum "
                  f"{r['d_checksum']}), pass 2 {r['pass2_ms']:.4f} ms",
                  flush=True)
    print(json.dumps({"device": smi, "reps": REPS, "results": results}),
          flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
