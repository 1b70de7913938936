#!/usr/bin/env python3
"""One MDR tile's steps timed apart on one CUDA device, with variants.

    python3 tools/mdr_tile_ab.py

At the tiles of chip_smoke.py's mdr-k3 (39,744 combos x 27 cells over
1,000 samples) and mdr-k4 (13,248 x 81) phases, times with CUDA events
(mean of 10 runs after a warm-up) each step of
``MDRFoldScorer._tile_tables``: the gather and base-3 fold of the cells,
the int8 one-hot (as the scorer builds it, cell-major with one
``torch.eq`` a cell, and as one broadcast ``torch.eq``, cell-major and
combo-major, and combo-major as a zero fill and one ``scatter_``),
the GEMM (as the scorer multiplies, weights x one-hot', and swapped,
one-hot x weights' with 16 columns), and the float32 epilogue; every
variant's one-hot and counts are held equal to the scorer's.  Prints one line a step and
variant with its time and its bytes over 3.35 TB/s, and the card's name
and power limit.
"""

from __future__ import annotations

import math
import subprocess
import sys
from pathlib import Path

import torch

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from chip_smoke import (HBM_BYTES_PER_S, check, cuda_ms,  # noqa: E402
                        planted_interaction)
from fastselect_tpu_torch.models.mdr import MDR  # noqa: E402
from fastselect_tpu_torch.ops import mdr_op  # noqa: E402
from fastselect_tpu_torch.utils.sklearn_compat import (  # noqa: E402
    StratifiedKFold)

SHAPES = {"mdr-k3": (3, 19, 1000, 500), "mdr-k4": (4, 20, 1000, 100)}


def report(label, ms, nbytes):
    floor = nbytes / HBM_BYTES_PER_S * 1e3
    print(f"  {label}: {ms:.4f} ms ({nbytes / 1e9:.3f} GB moved at least, "
          f"{floor:.4f} ms at 3.35 TB/s, {100 * floor / ms:.1f}%)",
          flush=True)


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("mdr_tile_ab: no CUDA device is available")
    dev = torch.device("cuda", 0)
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for label, (k, seed, n, p) in SHAPES.items():
        X, y, _ = planted_interaction(seed, n, p, k)
        splits = list(StratifiedKFold(5, shuffle=True,
                                      random_state=42).split(X, y))
        w_case, w_ctrl = MDR(k=k, cv=5)._fold_weights(y, splits)
        sc = mdr_op.MDRFoldScorer(X, w_case, w_ctrl, k, device=dev)
        tc, cells, n_pad, f = sc.tc, sc.n_cells, sc.n_pad, sc.n_folds
        n_combos = math.comb(p, k)
        tables = torch.from_numpy(mdr_op._comb_tables(p, k)).to(dev)
        combos = mdr_op._unrank_device(
            sc.chunk_ranks(n_combos // 2, tc, n_combos), tables, k=k)
        print(f"{label}: tile of {tc} combos x {cells} cells over {n_pad} "
              f"samples", flush=True)

        def fold():
            return sc.scaled[combos + sc.offsets].sum(dim=1,
                                                      dtype=torch.int16)

        cell_t = fold()
        report("gather and fold", cuda_ms(fold, 10),
               tc * k * n_pad * 2 * 2 + tc * n_pad * 2)
        hot = torch.empty((cells * tc, n_pad), dtype=torch.bool, device=dev)
        hot3 = hot.view(cells, tc, n_pad)
        levels = torch.arange(cells, dtype=torch.int16, device=dev)

        def onehot_per_cell():           # the scorer's: cell-major
            for c in range(cells):
                torch.eq(cell_t, c, out=hot3[c])

        def onehot_broadcast():
            torch.eq(cell_t[None], levels[:, None, None], out=hot3)

        by_combo = hot.view(tc, cells, n_pad)

        def onehot_combo_major():        # one broadcast eq, combo-major
            torch.eq(cell_t[:, None, :], levels[None, :, None], out=by_combo)

        samples = torch.arange(n_pad, device=dev)

        def onehot_scatter():            # combo-major
            hot.zero_()
            idx = cell_t.clamp_min(0).to(torch.int64) * n_pad + samples
            hot.view(tc, cells * n_pad).scatter_(1, idx, cell_t >= 0)

        onehot_combo_major()
        combo_major = hot.clone()
        hot.fill_(True)
        onehot_scatter()
        check(torch.equal(hot, combo_major), f"{label}: scatter")
        onehot_broadcast()
        want = hot.clone()
        hot.fill_(True)
        onehot_per_cell()
        check(torch.equal(hot, want), f"{label}: cell-major one-hots")
        check(torch.equal(want.view(cells, tc, n_pad).transpose(0, 1),
                          combo_major.view(tc, cells, n_pad)),
              f"{label}: cell-major == combo-major transposed")
        onehot_bytes = tc * cells * n_pad + tc * n_pad * 2
        report(f"one-hot, cell-major, {cells} eq calls (the scorer's)",
               cuda_ms(onehot_per_cell, 10), onehot_bytes)
        report("one-hot, cell-major, one broadcast eq",
               cuda_ms(onehot_broadcast, 10), onehot_bytes)
        report("one-hot, combo-major, one broadcast eq",
               cuda_ms(onehot_combo_major, 10), onehot_bytes)
        report("one-hot, combo-major, zero and scatter",
               cuda_ms(onehot_scatter, 10), onehot_bytes)
        a = want.view(torch.int8)
        w16 = sc.wt[:16]              # 2F = 10 rows rounded up to 8: N = 16
        counts = torch._int_mm(sc.wt, a.t())
        other = torch._int_mm(a, w16.t())
        check(torch.equal(other.t(), counts[:16]), f"{label}: the GEMMs")
        report("GEMM weights (32 rows) x one-hot' (the scorer's)", cuda_ms(
            lambda: torch._int_mm(sc.wt, a.t()), 10),
            a.numel() + sc.wt.numel() + counts.numel() * 4)
        report("GEMM one-hot x weights' (N = 16)", cuda_ms(
            lambda: torch._int_mm(a, w16.t()), 10),
            a.numel() + w16.numel() + other.numel() * 4)
        t = counts[:2 * f].view(2, f, cells, tc).transpose(2, 3)
        report("epilogue", cuda_ms(
            lambda: mdr_op._ba_and_key(t[0], t[1], sc.P, sc.N), 10),
            2 * f * tc * cells * 4 + f * tc * 12)
        report("whole tile (scorer)", cuda_ms(
            lambda: sc._score(combos, tc), 10),
            tc * cells * n_pad * 2)
        del hot, want, combo_major, a, counts, other, sc
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
