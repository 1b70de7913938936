#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check it.

Run from the repository root with one CUDA device visible:

    python3 chip_smoke.py

Phases, one or two lines each on stdout:

1. environment: torch, CUDA, the card and its power limit, nvcc, triton;
2. build: ``nvcc`` compiles ``fastselect_tpu_torch/csrc/*.cu`` for sm_90a,
   and ptxas's registers and spills of every kernel;
3. each kernel against its plain PyTorch version on the card: square and
   rectangular focal blocks, a shape ragged in nb, n and p, and large-p's
   128 x 128 x 100,000, whose pass 1 splits its features; for the
   ``MIXED`` kernels (60, 14, 30% of the columns discrete, leading) also
   every third column discrete and all columns discrete.  Pass 1 of
   either kind bit for bit, pass 2 within ``SCORE_RTOL`` and the same
   over two launches.  Then each kernel timed with CUDA events at the
   shapes the main path gives it and with features padded to 32 as the
   engines once padded them (p = 128 and 224), for comparison, the
   continuous ones also at mixed-square's continuous half, the ``MIXED``
   ones also all-discrete at 4,096 x 4,096 x 16,384, beside its bound,
   its plain version (whose output the kernel's is held against there as
   above: mixed-xl's focal block included) and, for pass 1,
   ``torch.cdist`` (p=1 continuous, p=0 all-discrete);
4. ``MultiSURF().fit`` at the upstream reference's large-n point,
   50,000 samples x 100 continuous features, first and warm, launching
   each rule kernel once a focal block, against the plain engine: the
   plain passes and the rule's chain of PyTorch operations, which launch
   nothing (so too every fit of phases 4-6 and 9 on the fused engine);
   the main path's launches, the references' taken off, go on each
   kernel's line as ``launches``;
5. the same at its large-p point, 100 samples x 100,000 features;
6. a small mixed fit (2,000 x 200 with 40 integer-valued columns) on the
   hybrid engine, a mixed fit with a 150-state discrete column on the
   fused engine's ``MIXED`` kernels, mixed-xl (150,000 x 100 with 40
   columns cut to 0..2: past the hybrid engine's 131,072 samples, so the
   ``MIXED`` kernels over 293 focal blocks of 512 rows), first and warm,
   against the hybrid engine called directly on the same rows, and
   MultiSURF and MultiSURF* on a 37 x 19 mixed input against the numpy
   oracle of the reference's semantics in ``tests/oracles.py``;
7. the SNP headline: ``MultiSURF().fit`` on 16,384 x 65,536 int8
   genotypes, through the integer fast path and the symmetric tier of the
   all-discrete engine (int8 GEMMs), timed first and warm, with the
   engine's int8 rate and peak memory; then the same genotypes fitted as
   an int8 tensor already on the card;
8. the engine's other tiers: v1 (ReliefF, 3,000 x 5,000, 3 classes), the
   v2 block loop (MultiSURF*, 30,000 x 2,048) and v2-sym again (SURF,
   8,192 x 16,384 float input, encoded on the card);
9. SURF and ReliefF on continuous data (10,000 x 100), ReliefF at
   50,000 x 100, and SURF, SURF* and ReliefF against ``tests/oracles.py``
   on the small mixed inputs of ``tests/test_surf.py`` and
   ``tests/test_relieff.py``;
10. the hybrid engine at size: mixed-square (16,384 x 4,096, half
    genotypes, one square class-sorted block) and mixed-large-n
    (50,000 x 100 with 40 columns cut to 0..2, focal blocks);
11. device-fit: the large-n data fitted as a float32 tensor on the card,
    against the host-array fit;
12. TuRF's fast scorer (4,096 x 16,384 genotypes, 10,000 x 1,000
    continuous, the same with 100 columns cut to 0..2) against a TuRF that
    re-fits its base estimator each round;
13. ``chi2`` on a float32 tensor of 2,000 x 200,000 counts on the card
    against the float64 host path;
14. mrmr: ``mRMR(n_features_to_select=10)`` on 2,000 x 5,000 codes 0..4
    with a binary y (the upstream mRMR grid's largest point), first and
    warm, then MIQ: the (p, p) redundancy matrix stays on the card.  Held
    against the streamed path (``FULL_REDUNDANCY_MAX_P`` set below p:
    equal ``top_features_``, relevance equal bit for bit), one 1,024 x
    1,024 pair tile's int8-GEMM tables against ``pair_tables_ref``
    (equal) and its MI block of the matrix against the same reduction of
    those tables (bit for bit), and 20 pairs against ``tests/oracles.py``;
15. mrmr-stream: the same on 2,000 x 50,000 codes (upstream's GWAS-p
    point), past ``FULL_REDUNDANCY_MAX_P``: relevance and the selected
    columns against ``feature_target_tables_ref`` on the card, and the
    greedy rerun over them;
16. cfs: ``CFS()`` on make_classification(5,000 x 2,000) with a planted
    column 0 and its noisy copy in column 1: column 0 selected, 1 not;
    the streamed path (``FULL_SU_MAX_P`` below p) selects alike; 20 SU
    pairs against ``tests/oracles.py``;
17. cfs-stream: ``CFS()`` on 2,000 x 20,000 planted genotypes, past
    ``FULL_SU_MAX_P``: search and prune rerun over the plain tables'
    r_cf and SU columns select alike, column 0 among them;
18. mdr: ``MDR(k=2, cv=5)`` on 2,000 x 200 genotypes (the upstream MDR
    grid's largest k = 2 point) with a planted pure 2-locus interaction,
    y = [(x_a + x_b) mod 3 == 0] with 10% of the labels flipped, first
    and warm: (a, b) found with CVC 5/5, and every fold's best rank and
    key equal to a full search through ``mdr_tables_ref``; then
    mdr-large-n, the same planting at k = 2 on 120,000 x 30 (training
    folds of 96,000: the key's bound 2PN past int32), each fold's winner
    equal to a float64 host oracle's;
19. mdr-k3: ``MDR(k=3, cv=5)`` on 1,000 x 500 (20,708,500 combos) with a
    planted 3-locus interaction, first and warm: found with CVC 5/5; in
    four chunks (the first, the planted combo's, the one before the last
    and the last with its padded tail) the device-unranked combos equal
    ``unrank_combos`` and the GEMM tables ``mdr_tables_ref``'s; each
    fold's winner's BA and held-out BA equal numpy oracles, and no
    sampled combo beats it;
20. mdr-k4: ``MDR(k=4, cv=5)`` on 1,000 x 100 (3,921,225 combos, 81
    cells) with a planted 4-locus interaction, found with CVC 5/5; the
    tail chunk's tables equal the plain ones;
21. the multi-device layer on a mesh of four shards on the first card
    (and on every card, where there is more than one), each beside the
    phase whose data it reuses and held against that phase's one-device
    result: mesh-large-n (phase 4's fit through the automatic route to
    ``sharded_relief_scores``: the continuous kernels on every shard) and
    mesh-mixed (phase 6's 150-state input, ``sharded_relief_scores``
    called directly: the MIXED kernels), after phase 6; mesh-snp (phase
    7's genotypes, routed to the feature shard), after phase 7; mesh-v2
    (tier-v2's data through the sample shard with class-sorted blocks
    dealt) and mesh-ring (the same with ``_RING_BYTES`` below the codes'
    bytes: the ring and its skip table), after phase 8; the sharded chi2
    inside phase 13; mesh-mdr (``MDR(k=3, cv=5)`` through
    ``ShardedMDRFoldScorer``: fold ranks and keys equal to phase 19's) and
    mesh-stats (mrmr's MI matrix with sharded pair tiles, bit for bit)
    after phase 20.  Each prints its time and peak memory;
22. profiling: ``utils.profiling.timed_fit`` on large-n, one fit's
    ``phase`` records at INFO, and one fit traced by
    ``utils.profiling.trace`` into ``build/trace-large-n/``;
23. mesh-procs: the mesh across processes.  Four processes sharing the
    first card join a gloo group (:func:`run_processes`:
    spawn, a ``FileStore`` in a temporary directory, a hard deadline of
    ``MESH_PROCS_DEADLINE_S``), each with a quarter of the card's
    focal-block budget, and run phase 21's layouts on the group's mesh
    (one shard a process) on the same data: mesh-procs-large-n (the
    automatic route: the continuous kernels in every process),
    mesh-procs-mixed (the ``MIXED`` kernels), mesh-procs-snp (the feature
    shard: its 1.07 GB int32 match summed by a host all_reduce),
    mesh-procs-v2, mesh-procs-ring (blocks handed across processes),
    mesh-procs-mdr and mesh-procs-stats.  Every rank's result equals every
    other's bit for bit, and phase 21's on the same four shards bit for
    bit, except mesh-procs-large-n, whose focal blocks follow the budget
    shared on the card: within phase 21's tolerance.
    Each prints its first and warm times, every process's peak memory and
    its collectives' calls, bytes and seconds; the ring's sweeps and rules
    are timed apart, here and in phase 21.  Then the collective helpers
    run on the card in a one-rank NCCL group;
24. gwas, after mesh-snp: the discrete engine's GWAS-scale route.  The
    pack and window functions on the card against their CPU versions byte
    for byte (2- and 4-bit codes, ragged p, gathered rows); phase 7's
    genotypes through the three forced routes (the sort budget at 0: the
    host array staged packed, then promoted; the promote budget at 0 too:
    gathered from packed codes; an int8 tensor on the card: gathered, bits
    0), each held to phase 7 within ``GWAS_TOL`` with equal
    ``top_features_``; gwas-promote, 6,000 x 2,600,000 host genotypes
    (past the card's packed-staging gate, under its promote gate) through
    ``MultiSURF().fit``: v2-promote, peak under 3 n p bytes, equal to the
    resident route on the same array; gwas-gather, 8,192 x 5,000,000
    genotypes drawn on the card straight into ``stage_codes_packed``
    (10.2 GB packed; 41 GB as int8) and scored from them: v2-gather, peak
    under n p / 2 bytes, column 0 first, and 2,049 features held to a
    referee that shares only ``pair_weight_rules`` with the engine
    (:func:`gwas_referee`).  Each route is read by spying on the engine's
    layout, promote and gather functions (:class:`RouteSpy`), and none may
    launch a fused kernel.  Its numbers go on the fits line and on a
    ``gwas:`` line before the JSON summary;
25. staging, after mesh-procs: the host-to-device staging layer
    (``utils/staging.py``).  ``MultiSURF().fit`` on the upstream
    reference's p >> n point, 100 x 500,000 float64 host X, at
    ``transfer_dtype`` None, 'float32', 'float16' and 'bfloat16', first
    and two warm, each launching the continuous kernels: the float32 fit
    (and None where it resolves to float32) equal to today's one-shot copy
    (the stager's gate raised) bit for bit, each half-width fit equal to
    the float32 fit of X rounded on the host by the same cast bit for
    bit; each with its peak memory and, from one more fit, the stager's
    ``staging.`` phase records (host cast, copy, analysis).  Then the
    stager's chunk widths (``CHUNK_SWEEP``) timed on the staged analysis
    of that X and the upload of phase 7's int8 codes, against one
    pageable copy of them, and the copy seconds of phases 5 (large-p, now
    staged), 7 and 24 (gwas-promote's packed staging).  Its numbers go on
    the fits line and on a ``staging:`` line before the JSON summary;
26. completeness, after staging: (a) ReliefF's weight rule (the
    neighbour-pick kernel on the fused engine, one stable sort of each
    focal row on the discrete one) on phase 9's large-n input (the
    continuous kernels and ``relieff_weights``), phase 8's v1 tier (3,000 x 5,000 genotypes, 3 classes: the
    discrete engine) and phase 6's 150-state mixed input (the ``MIXED``
    kernels), first and two warm fits with their peak memory, then one
    fit under ``utils.profiling.trace`` with the rule in a
    ``record_function`` range for its device time; large-n and v1 are
    held to phases 9 and 8's fits of the same estimator, the 150-state
    input ranks its planted column first; (b)
    ``fast_select_torch.MultiSURF(backend='gpu')``, the upstream import
    surface, on phase 4's data: scores equal phase 4's bit for bit, and no
    ``jax`` or ``fastselect_tpu`` module in the process; (c)
    ``examples/torch/gwas_workflow.py --n 16384 --p 65536 --backend
    cuda`` in a process of its own (deadline ``EXAMPLE_TIMEOUT_S``): it
    exits 0 and recovers the planted signals.  Launch counts are set to 0
    before it and read after (b): every kernel must launch, and the counts
    stand in the kernels' line as ``completeness_launches``.  Its numbers
    go on the fits line and on a ``completeness:`` line before the JSON
    summary;
27. windows, after phase 3: the discrete engine's window kernels
    (``csrc/relief_discrete.cu``) against their plain twins on the card,
    at the headline's window (16,384 int8 rows, FT 2,048) and at
    gwas-gather's (8,192 rows of 2-bit codes read through a class-order
    index, FT 1,024), focal blocks of 4,096 (``WINDOWS``):
    ``window_onehot`` bit for bit, transposed at FT (pass 2's operand)
    and flat at FT (the precomputed one-hot's tile) and at the width
    ``_match_rows`` gives pass 1 (``pass1_width``: 8,192 and 13,312
    features), over all rows and over one focal block; ``window_partials``
    on products built as ``_accumulate_plan`` builds them, for MultiSURF
    on a single-class and a straddling block, ReliefF with 3 classes,
    ReliefF on v1 with 60 classes (61 operands, as
    ``_accumulate_discrete`` builds them) and SURF's exact-int path (bit
    for bit, and equal to the eager chain it replaced), elsewhere within
    ``WINDOW_RTOL`` of sum_i |v[i, f]| a feature and the same over three
    launches (twice through one block's ``WindowPartials``, once through
    ``window_partials``).  Each timed with CUDA events, as the engine
    calls it, beside its twin, the eager chain it replaced (for the
    one-hot, the twin itself) and its bound in bytes.  Phases 7, 8 and
    24 count the window kernels' launches (``_build.launches``) over
    their fits: both kernels must launch in each;
28. relieff, after phases 4-6: ReliefF's neighbour-pick kernel
    (``csrc/relieff_select.cu``, ``ops/relief.py:relieff_weights``)
    against its twin, the sort chain ``_sum_rules(_rules_relieff(...))``,
    bit for bit and the same over two launches: on pass 1's D of large-n's
    first focal block (2,944 x 50,048 on the H100, k = 10, 2 classes) and
    on ``RELIEFF_CASES`` (tie-heavy integer distances with padded focal
    rows from row 47,104, 60 classes, 70 classes (nine groups of labels),
    k = 100, a class of 5 members, labels past class_probs, zeros of
    either sign).  Each timed with CUDA events (mean of 10): the whole
    call, the kernel's launch alone, and the sort chain (``library_ms``,
    mean of 3), beside the bound (8 B a pair at 3.35 TB/s);
29. threshold, after phase 28: MultiSURF's and SURF's rule kernels
    (``csrc/threshold_rule.cu``, ``ops/relief.py:threshold_weights``)
    against the chain they replace, ``_sum_rules(pair_weight_rules(...))``,
    on pass 1's D of large-n's first MultiSURF block (25,024 x 50,048 on
    the H100) as float32 and as float64, for MultiSURF, MultiSURF*, SURF
    and SURF*: two calls equal, and W the chain's bits on every row whose
    near mask agrees with the chain's, W's near mask that of the float64
    row sums' threshold but within ``THRESHOLD_ULPS`` ulps of it
    (``threshold_held``), and W the rule's on its own near mask.  Each timed with CUDA events (mean of 10): the
    statistics launch and the weights launch alone, the
    whole call and the chain (``library_ms``, mean of 3), beside each
    launch's bound (4 B a pair of float32 D for the statistics, 8 B for
    the weights, at 3.35 TB/s);
30. gemm, after phase 27: the discrete engine's int8 GEMM
    (``csrc/int8_gemm.cu``, ``ops/relief_discrete.py:int8_gemm``) against
    ``torch._int_mm`` bit for bit at the engine's shapes (``GEMM_CASES``:
    pass 1's 4,096 x 32,768 window at 6 and 2 tiles added into counts
    that are not zero, pass 2's 4,096 x 3,072 class segment starting off
    128 in rows 32,768 bytes apart, against the parent's cut at 8 too, a
    v2-sym block row written into its match matrix, a ragged small
    shape), each timed with CUDA events (mean of 10) beside its twin,
    ``_int_mm`` alone at the parent's operands (``library_ms``) and at
    the kernel's 128-byte aligned cut (``library_aligned_ms``), and its
    bound (2 m n k at the int8 peak); then a MultiSURF fit of snp-paper's
    size (30,000 x 200,000 codes on the card) through the kernel, its
    launches counted in all and at each case's shape, and as the parent
    computed it (``torch._int_mm``, an int32 add a pass-1 window of the
    parent's width, sizes and segments cut at 8): the scores bit for
    bit.  Phases 7, 8 and 24 count the kernel's launches beside the
    window kernels', and phase 21's mesh-snp, mesh-v2 and mesh-ring
    count them on their shards: it must launch in each.

Phases 14-20 print their first and warm fit times, int8 GEMM operations
(``relief_discrete.gemm_ops``) and rate, peak device memory, the host
seconds of the greedy loop (14-17) or outside MDR's search (18-20:
folds, lookup tables, held-out BAs; staging apart) and the phase's own
time, and 18-20 the share of the one-hots' HBM floor (bytes written and
read over 3.35 TB/s) in the search; each must run int8 GEMMs and launch
no Relief kernel.

Each mesh fit counts the launches over it, and sets
``relief_discrete.gemm_ops`` to 0 before it and reads it after it: the
continuous layouts must launch their kernels on the shards, the discrete
ones run int8 GEMMs and launch no Relief kernel, and each must reach its
layout's function.

Phases 4-6 are the main path of the four kernels: every kernel's
launches are counted over them (``_build.launches``), less the launches of
the small mixed fit's ``MIXED``-kernel reference and of mixed-xl's
hybrid referee, and each kernel must have been launched there by a fit
(the ``MIXED`` kernels by the 150-state and mixed-xl fits).  Phase 23's
processes must launch all four kernels too; their launches, summed over
the processes' first fits, stand in the kernels' line as
``mesh_procs_launches``.  A process that fails or outlives the deadline
fails the script.
Each fused-engine fit there and in phase 9 is held against the same
engine run on the card with the plain PyTorch passes.  Phases 7 and 8 are
the all-discrete path: the GEMM operation count is set to 0 before each
fit and read after it, no fused kernel may launch in it, and each fit is
held against the fused engine with the ``MIXED`` kernels on the same data
as float32, the route all-discrete data took before.  Each hybrid fit
must launch the continuous kernels and the int8 GEMMs and no ``MIXED``
kernel, and is held against the fused engine with the ``MIXED`` kernels
on the same rows in the hybrid's order.  Any failed check raises, so the
script exits non-zero; it also fails when no CUDA device is present.  The
line before the last is a JSON summary of the ten kernels (launches,
errors, times, bounds and registers, per timed shape; the window
kernels' and the int8 GEMM's launches are phase 7's, with phases 7, 8
and 24, and for the GEMM phase 21's discrete mesh layouts, apart under
``phase_launches``); the last line is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import collections
import datetime
import hashlib
import importlib.util
import json
import logging
import math
import pickle
import re
import shutil
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

import fast_select_torch
from fastselect_tpu_torch import (CFS, MDR, MultiSURF, ReliefF, SURF, TuRF,
                                  _build, chi2, mRMR, parallel)
from fastselect_tpu_torch.models import _relief_base
from fastselect_tpu_torch.models import cfs as cfs_mod
from fastselect_tpu_torch.models import mdr as mdr_mod
from fastselect_tpu_torch.models import mrmr as mrmr_mod
from fastselect_tpu_torch.ops import contingency as ct
from fastselect_tpu_torch.ops import mdr_op
from fastselect_tpu_torch.ops import relief as relief_mod
from fastselect_tpu_torch.ops import relief_cuda as rc
from fastselect_tpu_torch.ops import relief_discrete as rd
from fastselect_tpu_torch.ops import relief_hybrid as rh
from fastselect_tpu_torch.ops.chi2_op import chi2_stats_exact
from fastselect_tpu_torch.ops.relief import relief_engine
from fastselect_tpu_torch.parallel import feature_shard
from fastselect_tpu_torch.parallel import sharded as psh
from fastselect_tpu_torch.utils import profiling, staging
from fastselect_tpu_torch.utils.preprocessing import (analyze_features,
                                                      analyze_features_staged)
from fastselect_tpu_torch.utils.profiling import PEAKS
from fastselect_tpu_torch.utils.sklearn_compat import (HAVE_SKLEARN,
                                                       StratifiedKFold)

# Kernel name -> (source, Pallas kernel it replaces)
KERNELS = {
    "relief_pass1_cont": ("fastselect_tpu_torch/csrc/relief_pass1.cu",
                          "fastselect_tpu/ops/relief_pallas.py:82"),
    "relief_pass1_mixed": ("fastselect_tpu_torch/csrc/relief_pass1.cu",
                           "fastselect_tpu/ops/relief_pallas.py:63"),
    "relief_pass2_cont": ("fastselect_tpu_torch/csrc/relief_pass2.cu",
                          "fastselect_tpu/ops/relief_pallas.py:126"),
    "relief_pass2_mixed": ("fastselect_tpu_torch/csrc/relief_pass2.cu",
                           "fastselect_tpu/ops/relief_pallas.py:103"),
}
# The discrete engine's window kernels ->
# (source, the JAX code it stands for: a fusion XLA makes inside the
# engine's window scan, not a Pallas kernel)
WINDOW_KERNELS = {
    "window_onehot": ("fastselect_tpu_torch/csrc/relief_discrete.cu",
                      "fastselect_tpu/ops/relief_discrete.py:55"),
    "window_partials": ("fastselect_tpu_torch/csrc/relief_discrete.cu",
                        "fastselect_tpu/ops/relief_discrete.py:596"),
}
# The fused engine's rule kernels -> (source, the JAX code each stands
# for: XLA's fusions inside the rule, no Pallas kernel)
RULE_KERNELS = {
    "relieff_weights": ("fastselect_tpu_torch/csrc/relieff_select.cu",
                        "fastselect_tpu/ops/relief.py:_rules_relieff"),
    "threshold_stats": ("fastselect_tpu_torch/csrc/threshold_rule.cu",
                        "fastselect_tpu/ops/relief.py:_rules_multisurf"),
    "threshold_weights": ("fastselect_tpu_torch/csrc/threshold_rule.cu",
                          "fastselect_tpu/ops/relief.py:_rules_multisurf"),
}
# The discrete engine's int8 GEMM -> (source, what it replaces: no Pallas
# kernel, the JAX package leaves the products to XLA's dot_general)
GEMM_KERNELS = {
    "int8_gemm": ("fastselect_tpu_torch/csrc/int8_gemm.cu",
                  "torch._int_mm; fastselect_tpu/ops/relief_discrete.py "
                  "dot_general"),
}
# the fused engine's kernels: its two passes of each kind and its rules
FUSED_KERNELS = (*KERNELS, *RULE_KERNELS)
# __global__ functions of each of the ten kernels, as ptxas names them
# (mangled: pass 1's kind template has the instances ILb0 and ILb1, each
# with a float and a double accumulator)
KERNEL_FUNCTIONS = {"relief_pass1_cont": ("dist_kernelILb0",
                                          "split_sum_kernel"),
                    "relief_pass1_mixed": ("dist_kernelILb1",
                                           "split_sum_kernel"),
                    "relief_pass2_cont": ("accum_kernel_cont",),
                    "relief_pass2_mixed": ("accum_kernel_mixed",),
                    "window_onehot": ("onehot_kernel", "onehot_t_kernel"),
                    "window_partials": ("partials_kernel",
                                        "partials_finish_kernel"),
                    "relieff_weights": ("relieff_select_kernel",),
                    "threshold_stats": ("threshold_stats_kernel",),
                    "threshold_weights": ("threshold_weights_kernel",),
                    "int8_gemm": ("int8_gemm_kernel",)}
# pass 1 of either kind must equal its plain version bit for bit
SCORE_RTOL = 1e-3    # pass 2 against its plain version, relative to max|s|
FIT_ATOL = 1e-4      # fitted scores against the plain-pass engine
ORACLE_ATOL = 2e-6   # against tests/oracles.py, as tests/test_multisurf.py
ORACLE_ATOL_SR = 5e-6  # as tests/test_surf.py and tests/test_relieff.py
DEVICE_FIT_ATOL = 1e-6  # a tensor fit against the host-array fit (expected: 0)
DISC_TOL = (2e-7, 1e-6)  # an all-discrete mesh fit against one device's
#                         (atol, rtol; tests/test_sharding.py:213)
TURF_ATOL = 1e-5     # TuRF's fast scorers against its re-fitting loop
CHI2_RTOL = 1e-4     # chi2 on the card against the float64 host path
ORACLE_ATOL_MI = 1e-4  # MI and SU against tests/oracles.py (float64)
PLAIN_ATOL_MI = 1e-6   # streamed statistics against the plain tables'
MDR_BA_ATOL = 1e-6     # a fold winner's float32 BA against the float64 oracle
# phase 24: a GWAS-scale route against another route or the referee
# (atol: tests/test_engines.py:363,554,583; rtol for the larger scores)
GWAS_TOL = (5e-7, 1e-6)
# phase 27: window_partials against its twin, per feature, relative to
# sum_i |v[i, f]| (the two sum the same float32 values in other orders)
WINDOW_RTOL = 1e-6
# the bounds' card, an H100 SXM at 700 W (NVIDIA's data sheet)
_H100 = PEAKS["NVIDIA H100 80GB HBM3"]
INT8_PEAK_TOPS = _H100.int8_tops                # dense int8, TOP/s
FP32_PEAK_FLOPS = _H100.fp32_tflops * 1e12      # outside the tensor cores
HBM_BYTES_PER_S = _H100.hbm_gbps * 1e9          # device memory
ALGO = {"MultiSURF": "multisurf", "SURF": "surf", "ReliefF": "relieff"}
# phase 21's results on its first mesh (four shards on the first card),
# which phase 23's processes are held to
MESH_RESULTS: dict = {}
# phase 21's launches of the int8 GEMM on its first mesh, by layout
MESH_GEMM_LAUNCHES: dict = {}
# phase 23: processes sharing the first card, and their hard deadline
MESH_PROCS = 4
MESH_PROCS_DEADLINE_S = 300.0
# phase 25: the stager's chunk widths timed (bytes a staged chunk)
CHUNK_SWEEP = tuple(mb << 20 for mb in (8, 16, 32, 64, 128, 256))
# phase 26: the profiler range around ReliefF's weight rule, where traces
# go, and the GWAS example's deadline
RULES_RANGE = "fs.relieff_rules"
BUILD_DIR = Path(__file__).resolve().parent / "build"
EXAMPLE_TIMEOUT_S = 300.0
JAX_PACKAGES = ("jax", "fastselect_tpu")   # none may be in sys.modules
# the card's name and power limit (nvidia-smi), set by main
SMI = "not read"


# ---------------------------------------------------------------------------
# Data: sklearn.datasets.make_classification, reproduced draw for draw
# ---------------------------------------------------------------------------

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


def make_classification(n_samples=100, n_features=20, *, n_informative=2,
                        n_redundant=2, n_classes=2, n_clusters_per_class=2,
                        flip_y=0.01, class_sep=1.0, random_state=0):
    """The data of ``sklearn.datasets.make_classification`` with the same
    arguments (no repeated features, hypercube, no shift or scale,
    shuffled): the same ``RandomState`` draws in the same order.  The
    script must also run where scikit-learn is not installed."""
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


# ---------------------------------------------------------------------------
# Helpers
# ---------------------------------------------------------------------------

def check(ok, what):
    if not ok:
        raise RuntimeError(f"check failed: {what}")


def launch_counts(names=FUSED_KERNELS):
    """The launches so far of each kernel of ``names``
    (``_build.launches``)."""
    return {k: _build.launches[k] for k in names}


def launches_since(before):
    """The launches of each kernel of ``before`` (:func:`launch_counts`)
    since it was taken."""
    return {k: _build.launches[k] - v for k, v in before.items()}


def run(cmd):
    return subprocess.run(cmd, capture_output=True, text=True,
                          timeout=60).stdout.strip()


class PhaseRecords:
    """Within the block (when ``on``), the package's ``phase`` records
    whose names start with ``prefix`` are kept: INFO is on, so each of
    them synchronises the cards at its edges and times the device."""

    def __init__(self, prefix, on=True):
        self.prefix, self.on, self.records = prefix, on, []

    def __enter__(self):
        if self.on:
            self.logger = logging.getLogger("fastselect_tpu_torch")
            self.level = self.logger.level
            self.handler = logging.Handler()
            self.handler.emit = self._emit
            self.logger.setLevel(logging.INFO)
            self.logger.addHandler(self.handler)
        return self

    def _emit(self, record):
        msg = record.getMessage()
        if msg.startswith(self.prefix):
            name, rest = msg.split(": ", 1)
            self.records.append((name, float(rest.split("s")[0])))

    def __exit__(self, *exc):
        if self.on:
            self.logger.removeHandler(self.handler)
            self.logger.setLevel(self.level)

    def summary(self):
        return ", ".join(f"{name} {sec:.4f} s" for name, sec in self.records)


def cuda_ms(fn, reps, warmup=1):
    """Mean milliseconds per call of fn on the card, by CUDA events."""
    for _ in range(warmup):
        fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def random_inputs(dev, n, p, n_disc, seed, stride=1):
    """Padded-engine-like inputs: X (n, p) with n_disc integer-valued
    columns flagged discrete (every ``stride``-th from column 0: by
    default the leading ones, the engine's layout), and recip from the
    column ranges."""
    rng = np.random.RandomState(seed)
    x = rng.rand(n, p).astype(np.float32)
    cols = np.arange(n_disc) * stride
    x[:, cols] = rng.randint(0, 3, (n, n_disc))
    disc = np.zeros(p, np.float32)
    disc[cols] = 1.0
    recip = (1.0 / np.maximum(x.max(0) - x.min(0), 1e-6)).astype(np.float32)
    t = lambda a: torch.from_numpy(a).to(dev)  # noqa: E731
    return t(x), t(recip), t(disc)


def fit_tol(ref):
    """FIT_ATOL, relative to the largest score where that exceeds 1: SURF's
    unit weights make its scores grow with n."""
    return FIT_ATOL * max(1.0, float(np.abs(ref).max()))


def engine_args(est, y_enc):
    """The engine arguments the estimator's fit passes for labels y_enc."""
    kw = dict(algo=ALGO[type(est).__name__],
              use_star=getattr(est, "use_star", False))
    if kw["algo"] == "relieff":
        kw.update(n_neighbors=est.n_neighbors,
                  class_probs=(np.bincount(y_enc) / len(y_enc)).astype(
                      np.float32))
    return kw


def timed_fit(dev, est, X, y):
    """(fitted est, seconds, peak device GB) of one fit on the card."""
    torch.cuda.reset_peak_memory_stats(dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    est.fit(X, y)
    torch.cuda.synchronize()
    return (est, time.perf_counter() - t0,
            torch.cuda.max_memory_allocated(dev) / 1e9)


def fit_phase(dev, label, X, y, must_launch, n_select=10, make=MultiSURF,
              warm=0, **params):
    """Fit through the estimator (then ``warm`` more, timed), check that it
    launched the kernels named in must_launch and its rule's kernels once
    a focal block, then hold it against the plain engine on the card: the
    plain passes and the rule's chain of PyTorch operations, no kernel.
    Returns the fitted estimator and the first fit's seconds."""
    est = make(n_features_to_select=n_select, **params)
    y_enc = np.unique(y, return_inverse=True)[1]
    kw = engine_args(est, y_enc)
    plan = rc.block_plan(X.shape[0], X.shape[1], dev, kw["algo"])
    before = launch_counts()
    est, fit_s, peak_gb = timed_fit(dev, est, X, y)
    moved = launches_since(before)
    warm_s = [timed_fit(dev, make(n_features_to_select=n_select, **params),
                        X, y)[1] for _ in range(warm)]
    s = est.feature_importances_
    check(est.effective_backend_ == "cuda", f"{label}: effective_backend_")
    for name in must_launch:
        check(moved[name] > 0, f"{label}: the fit launched {name}")
    # one launch of each rule kernel a focal block, as of pass 1
    blocks = moved["relief_pass1_cont"] + moved["relief_pass1_mixed"]
    rule = (("relieff_weights",) if kw["algo"] == "relieff"
            else ("threshold_stats", "threshold_weights"))
    check(blocks > 0 and all(moved[name] == blocks for name in rule),
          f"{label}: {rule} launched once a focal block: {moved}")
    check(s.shape == (X.shape[1],) and np.isfinite(s).all(),
          f"{label}: finite scores of shape ({X.shape[1]},)")
    x_dev = torch.tensor(X, dtype=torch.float32, device=dev)
    fa = analyze_features(x_dev, est.discrete_limit)
    before = launch_counts()
    t0 = time.perf_counter()
    ref = rc.relief_fused_scores(
        x_dev, y_enc, fa.recip, fa.is_discrete, device=dev,
        _pass1=rc.dist_matrix_ref, _pass2=rc.accumulate_ref,
        _rule=relief_mod.chain_rule, **kw)
    ref_s = time.perf_counter() - t0
    check(launch_counts() == before, f"{label}: the plain engine launched no "
          f"kernel: {before} -> {launch_counts()}")
    ref_top = np.argsort(ref)[::-1][:n_select]
    err = float(np.abs(s - ref).max())
    check(err <= fit_tol(ref), f"{label}: max |scores - plain engine| = "
          f"{err}")
    check(np.array_equal(est.top_features_, ref_top),
          f"{label}: top_features_ {est.top_features_} vs {ref_top}")
    print(f"{label}: {type(est).__name__} X {X.shape[0]}x{X.shape[1]} fit "
          f"{fit_s:.4f} s{''.join(f', warm {t:.4f} s' for t in warm_s)} "
          f"(plain engine {ref_s:.4f} s); n_pad "
          f"{plan.n_pad} p_pad {plan.p_pad} nb {plan.nb} "
          f"({plan.n_pad // plan.nb} blocks); peak {peak_gb:.2f} GB; "
          f"launches {moved}; max |scores - plain| {err:.3e}; top_features_ "
          f"{est.top_features_.tolist()} equal", flush=True)
    return est, fit_s


def load_oracles():
    spec = importlib.util.spec_from_file_location(
        "oracles", Path(__file__).resolve().parent / "tests" / "oracles.py")
    oracle = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(oracle)
    return oracle


def oracle_phase():
    """The estimator on the card against the numpy oracle of the
    reference's CPU semantics (tests/oracles.py), on the small mixed input
    of tests/test_multisurf.py::test_oracle_parity."""
    oracle = load_oracles()
    rng = np.random.RandomState(0)
    X = rng.rand(37, 19).astype(np.float32)
    X[:, 3] = rng.randint(0, 3, 37)
    X[:, 7] = rng.randint(0, 5, 37)
    y = rng.randint(0, 2, 37)
    for use_star in (False, True):
        est = MultiSURF(n_features_to_select=5, use_star=use_star).fit(X, y)
        want = oracle.multisurf_scores(X, y, use_star=use_star)
        err = float(np.abs(est.feature_importances_ - want).max())
        check(est.effective_backend_ == "cuda", "oracle: on the card")
        check(err <= ORACLE_ATOL, f"oracle use_star={use_star}: err {err}")
        check(np.array_equal(np.argsort(est.feature_importances_),
                             np.argsort(want)),
              f"oracle use_star={use_star}: ranking")
        print(f"oracle: MultiSURF(use_star={use_star}) 37x19 mixed on the "
              f"card vs tests/oracles.py: max |scores - oracle| {err:.3e}, "
              f"ranking equal", flush=True)


def oracle_phase_surf_relieff():
    """SURF, SURF* and ReliefF on the card against tests/oracles.py, on
    the inputs of tests/test_surf.py::test_oracle_parity and
    tests/test_relieff.py::test_oracle_parity_{binary,multiclass}."""
    oracle = load_oracles()
    cases = []
    for use_star in (False, True):
        rng = np.random.RandomState(0)
        X = rng.rand(41, 23).astype(np.float32)
        X[:, 5] = rng.randint(0, 4, 41)
        y = rng.randint(0, 2, 41)
        cases.append((SURF(n_features_to_select=5, use_star=use_star), X, y,
                      oracle.surf_scores(X, y, use_star=use_star)))
    for k in (1, 3, 7):
        rng = np.random.RandomState(0)
        X = rng.rand(35, 13).astype(np.float32)
        X[:, 2] = rng.randint(0, 3, 35)
        y = rng.randint(0, 2, 35)
        cases.append((ReliefF(n_features_to_select=5, n_neighbors=k), X, y,
                      oracle.relieff_scores(X, y, k=k)))
    rng = np.random.RandomState(0)
    X = rng.rand(42, 9).astype(np.float32)
    y = rng.randint(0, 4, 42)
    cases.append((ReliefF(n_features_to_select=3, n_neighbors=3), X, y,
                  oracle.relieff_scores(X, y, k=3)))
    for est, X, y, want in cases:
        est.fit(X, y)
        err = float(np.abs(est.feature_importances_ - want).max())
        name = (f"{type(est).__name__}(use_star={est.use_star})"
                if isinstance(est, SURF)
                else f"ReliefF(n_neighbors={est.n_neighbors})")
        check(est.effective_backend_ == "cuda", "oracle: on the card")
        check(err <= ORACLE_ATOL_SR, f"oracle {name}: err {err}")
        print(f"oracle: {name} {X.shape[0]}x{X.shape[1]} on the card vs "
              f"tests/oracles.py: max |scores - oracle| {err:.3e}",
              flush=True)


# ---------------------------------------------------------------------------
# The all-discrete engine
# ---------------------------------------------------------------------------

def planted_genotypes(seed, n, p, n_classes, strengths=(0.6, 0.45, 0.3)):
    """Genotypes 0..2 with labels; column j carries the label in a share
    ``strengths[j]`` of the rows, so that the top features are far apart."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 3, (n, p), dtype=np.int8)
    y = rng.randint(0, n_classes, n)
    for j, share in enumerate(strengths):
        keep = rng.rand(n) < share
        X[keep, j] = (y[keep] % 3).astype(np.int8)
    return X, y


def fused_mixed_scores(dev, X, y_enc, kw, order, recip=None,
                       is_discrete=None):
    """The fused engine with the MIXED kernels on X as float32, rows in
    ``order`` (the discrete or hybrid engine's), with every column
    discrete and recip 1 unless given: (scores, seconds, launches).  Both
    engines then add D in the same row order in the weight rules' float32
    row sums."""
    before = launch_counts()
    xs = torch.from_numpy(np.ascontiguousarray(X[order])).to(dev)
    xs = xs.to(torch.float32)
    p = X.shape[1]
    if recip is None:
        recip = torch.ones(p, device=dev)
        is_discrete = torch.ones(p, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = rc.relief_fused_scores(
        xs, y_enc[order], recip, is_discrete, device=dev, **kw)
    sec = time.perf_counter() - t0
    del xs
    torch.cuda.empty_cache()
    return ref, sec, launches_since(before)


def discrete_phase(dev, label, est, X, y, tier, warm=0):
    """An all-discrete fit on the card: the tier it must take, no fused
    launch, GEMM work counted, and its scores held against the fused
    engine with the MIXED kernels.  Returns a dict of what it measured."""
    n, p = X.shape
    y_enc = np.unique(y, return_inverse=True)[1]
    kw = engine_args(est, y_enc)
    got = rd.discrete_tier(n, p, 3, y_enc, kw["algo"],
                           kw.get("class_probs"), device=dev)
    check(got == tier, f"{label}: tier {got}, expected {tier}")
    before = launch_counts()
    window0 = launch_counts((*WINDOW_KERNELS, *GEMM_KERNELS))
    times, peaks = [], []
    for _ in range(1 + warm):
        rd.reset_gemm_ops()
        est, sec, peak = timed_fit(dev, est, X, y)
        times.append(sec)
        peaks.append(peak)
    ops = rd.gemm_ops
    window = launches_since(window0)
    moved = launches_since(before)
    s = est.feature_importances_
    check(est.effective_backend_ == "cuda", f"{label}: effective_backend_")
    check(not any(moved.values()), f"{label}: fused launches {moved}")
    check(all(window.values()), f"{label}: window kernels and the int8 "
          f"GEMM launched {window}")
    check(ops > 0, f"{label}: no int8 GEMM ran")
    check(est.is_discrete_.all(), f"{label}: every column discrete")
    check(s.shape == (p,) and np.isfinite(s).all(),
          f"{label}: finite scores of shape ({p},)")
    check(est.top_features_[0] == 0, f"{label}: column 0 ranks first")

    order = (np.arange(n) if tier == "v1"
             else np.argsort(y_enc, kind="stable"))
    ref, ref_s, ref_moved = fused_mixed_scores(dev, X, y_enc, kw, order)
    ref_top = np.argsort(ref)[::-1][:len(est.top_features_)]
    err = float(np.abs(s - ref).max())
    check(ref_moved["relief_pass1_mixed"] > 0
          and ref_moved["relief_pass2_mixed"] > 0,
          f"{label}: reference launched the MIXED kernels")
    check(err <= fit_tol(ref), f"{label}: max |scores - MIXED engine| = "
          f"{err}")
    check(np.array_equal(est.top_features_, ref_top),
          f"{label}: top_features_ {est.top_features_} vs {ref_top}")
    warm_s = f", warm {', '.join(f'{t:.4f}' for t in times[1:])} s" \
        if warm else ""
    print(f"{label}: {type(est).__name__} X {n}x{p} {X.dtype} tier {tier}; "
          f"fit {times[0]:.4f} s{warm_s}; gemm_ops {ops:.4e}; peak "
          f"{max(peaks):.2f} GB; window kernels and int8 GEMM {window}; "
          f"MIXED-kernel "
          f"fused engine {ref_s:.4f} s; max |scores - MIXED| {err:.3e}; "
          f"top_features_ {est.top_features_.tolist()} equal", flush=True)
    return dict(first_s=times[0], warm_s=times[1:], gemm_ops=ops,
                peak_gb=max(peaks), mixed_s=ref_s, err=err, scores=s,
                window_launches=window)


def engine_rate(dev, X, y):
    """The engine alone on device-resident codes: (seconds, int8 ops)."""
    codes = torch.from_numpy(X).to(dev)
    rd.reset_gemm_ops()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rd.relief_discrete_scores(None, y, algo="multisurf", codes=codes,
                              n_states=3)
    torch.cuda.synchronize()
    return time.perf_counter() - t0, rd.gemm_ops


# ---------------------------------------------------------------------------
# The hybrid engine, device-tensor fits, TuRF and chi2
# ---------------------------------------------------------------------------

def quantized(X, cols):
    """X with ``cols`` cut into 3 states at -0.5 and 0.5 (0..2), so that
    an informative column stays informative when it turns discrete."""
    X = X.copy()
    X[:, cols] = np.digitize(X[:, cols], [-0.5, 0.5])
    return X


def hybrid_phase(dev, label, X, y, n_select=10, warm=0):
    """A mixed MultiSURF fit on the card (then ``warm`` more, timed): it
    must take the hybrid engine (continuous kernels and int8 GEMMs, no
    MIXED launch), and is held against the fused engine with the MIXED
    kernels on the same rows in the hybrid's order (class-sorted on the
    square v2 path).  Returns the fitted estimator, the first fit's
    seconds and the reference's kernel launches."""
    n, p = X.shape
    est = MultiSURF(n_features_to_select=n_select)
    y_enc = np.unique(y, return_inverse=True)[1]
    kw = engine_args(est, y_enc)
    fa = analyze_features(torch.tensor(X, dtype=torch.float32, device=dev),
                          est.discrete_limit)
    disc = fa.is_discrete.cpu().numpy()
    n_states = fa.n_states
    route = relief_engine(n, disc, n_states)
    check(route == "hybrid", f"{label}: route {route}")
    plan = rh.hybrid_plan(n, int((~disc).sum()), int(disc.sum()),
                          n_states, dev, kw["algo"])
    square = plan.nb == plan.n_pad
    sorted_rows = square and rd._v2_layout(
        y_enc, n, 8, kw["algo"], kw.get("class_probs")) is not None
    before = launch_counts()
    rd.reset_gemm_ops()
    est, fit_s, peak_gb = timed_fit(dev, est, X, y)
    ops = rd.gemm_ops
    moved = launches_since(before)
    warm_s = [timed_fit(dev, est, X, y)[1] for _ in range(warm)]
    s = est.feature_importances_
    check(est.effective_backend_ == "cuda", f"{label}: effective_backend_")
    check(moved["relief_pass1_cont"] > 0 and moved["relief_pass2_cont"] > 0,
          f"{label}: continuous kernels launched {moved}")
    check(moved["relief_pass1_mixed"] == 0
          and moved["relief_pass2_mixed"] == 0,
          f"{label}: no MIXED launch {moved}")
    check(ops > 0, f"{label}: no int8 GEMM ran")
    check(np.array_equal(est.is_discrete_, disc), f"{label}: is_discrete_")
    check(s.shape == (p,) and np.isfinite(s).all(),
          f"{label}: finite scores of shape ({p},)")

    order = (np.argsort(y_enc, kind="stable") if sorted_rows
             else np.arange(n))
    ref, ref_s, ref_moved = fused_mixed_scores(
        dev, X, y_enc, kw, order, fa.recip, fa.is_discrete)
    del fa
    ref_top = np.argsort(ref)[::-1][:n_select]
    err = float(np.abs(s - ref).max())
    check(ref_moved["relief_pass1_mixed"] > 0
          and ref_moved["relief_pass2_mixed"] > 0,
          f"{label}: reference launched the MIXED kernels")
    check(err <= fit_tol(ref), f"{label}: max |scores - MIXED engine| = "
          f"{err}")
    check(np.array_equal(est.top_features_, ref_top),
          f"{label}: top_features_ {est.top_features_} vs {ref_top}")
    path = ("square, class-sorted rows" if sorted_rows else "square"
            if square else f"blocked, {plan.n_pad // plan.nb} focal blocks")
    print(f"{label}: MultiSURF X {n}x{p} ({int(disc.sum())} discrete, "
          f"{n_states} states) hybrid {path}; plan n_pad "
          f"{plan.n_pad} p_c_pad {plan.p_c_pad} p_d_pad {plan.p_d_pad} ftd "
          f"{plan.ftd} nb {plan.nb}; fit {fit_s:.4f} s"
          f"{''.join(f', warm {t:.4f} s' for t in warm_s)}; gemm_ops "
          f"{ops:.4e}; launches {moved}; peak {peak_gb:.2f} GB; "
          f"MIXED-kernel fused engine {ref_s:.4f} s; max |scores - MIXED| "
          f"{err:.3e}; top_features_ {est.top_features_.tolist()} equal",
          flush=True)
    return est, fit_s, ref_moved


def mixed_xl_phase(dev, X, y, warm=1):
    """MultiSURF on mixed data past ``HYBRID_MAX_N`` samples: it must take
    the fused engine (the MIXED kernels, over focal blocks; no continuous
    launch), and is held against the hybrid engine called directly on the
    same rows (its blocked path takes any n: the continuous kernels and
    the int8 GEMMs).  Returns the first fit's seconds, the warm fits'
    seconds and the referee's kernel launches."""
    n, p = X.shape
    label = "mixed-xl"
    y_enc = np.unique(y, return_inverse=True)[1]
    x_dev = torch.from_numpy(X).to(dev)
    fa = analyze_features(x_dev, MultiSURF().discrete_limit)
    disc = fa.is_discrete.cpu().numpy()
    n_states = fa.n_states
    route = relief_engine(n, disc, n_states)
    check(route == "fused", f"{label}: route {route}")
    plan = rc.block_plan(n, p, dev, n_disc=int(disc.sum()))
    before = launch_counts()
    est, fit_s, peak_gb = timed_fit(dev, MultiSURF(n_features_to_select=10),
                                    X, y)
    moved = launches_since(before)
    warm_s = [timed_fit(dev, MultiSURF(n_features_to_select=10), X, y)[1]
              for _ in range(warm)]
    s = est.feature_importances_
    blocks = plan.n_pad // plan.nb
    check(est.effective_backend_ == "cuda", f"{label}: effective_backend_")
    check(moved["relief_pass1_mixed"] == blocks
          and moved["relief_pass2_mixed"] == blocks
          and moved["relief_pass1_cont"] == moved["relief_pass2_cont"] == 0,
          f"{label}: one MIXED launch of each pass a focal block, no "
          f"continuous launch: {moved}")
    check(est.is_discrete_[:40].all() and not est.is_discrete_[40:].any(),
          f"{label}: exactly the 40 cut columns are discrete")
    check(s.shape == (p,) and np.isfinite(s).all(),
          f"{label}: finite scores of shape ({p},)")

    before = launch_counts()
    rd.reset_gemm_ops()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    ref = rh.relief_hybrid_scores(x_dev, y_enc, fa.recip, fa.is_discrete,
                                  algo="multisurf", codes=fa.codes,
                                  n_states=n_states)
    ref_s = time.perf_counter() - t0
    ref_moved = launches_since(before)
    ops = rd.gemm_ops
    del x_dev, fa
    torch.cuda.empty_cache()
    ref_top = np.argsort(ref)[::-1][:10]
    err = float(np.abs(s - ref).max())
    check(ref_moved["relief_pass1_cont"] > 0 and ops > 0
          and ref_moved["relief_pass1_mixed"] == 0,
          f"{label}: the hybrid referee ran its continuous kernels and "
          f"GEMMs ({ops} ops, launches {ref_moved})")
    check(err <= fit_tol(ref), f"{label}: max |scores - hybrid engine| = "
          f"{err}")
    check(np.array_equal(est.top_features_, ref_top),
          f"{label}: top_features_ {est.top_features_} vs {ref_top}")
    print(f"{label}: MultiSURF X {n}x{p} ({int(disc.sum())} discrete, "
          f"{n_states} states) route fused; plan n_pad "
          f"{plan.n_pad} p_pad {plan.p_pad} nb {plan.nb} ({blocks} focal "
          f"blocks); fit {fit_s:.4f} s"
          f"{''.join(f', warm {t:.4f} s' for t in warm_s)}; peak "
          f"{peak_gb:.2f} GB; launches {moved}; hybrid engine (referee) "
          f"{ref_s:.4f} s, launches {ref_moved}; max |scores - hybrid| "
          f"{err:.3e}; top_features_ {est.top_features_.tolist()} equal",
          flush=True)
    return fit_s, warm_s, ref_moved


def device_fit_phase(dev, label, X, y, host_est, host_s):
    """``fit`` on X already on the card as a tensor: the host-array fit's
    model, with no host copy of X.  Returns the fit's seconds."""
    Xt = torch.from_numpy(X).to(dev)
    before = launch_counts()
    est, fit_s, peak_gb = timed_fit(
        dev, MultiSURF(n_features_to_select=len(host_est.top_features_)),
        Xt, y)
    moved = launches_since(before)
    err = float(np.abs(est.feature_importances_
                       - host_est.feature_importances_).max())
    check(est.effective_backend_ == "cuda", f"{label}: effective_backend_")
    check(err <= DEVICE_FIT_ATOL, f"{label}: max |tensor - array fit| {err}")
    check(np.array_equal(est.top_features_, host_est.top_features_),
          f"{label}: top_features_")
    del Xt
    torch.cuda.empty_cache()
    print(f"{label}: MultiSURF on a tensor ({X.dtype}) {X.shape[0]}x"
          f"{X.shape[1]} on the card: fit {fit_s:.4f} s (host-array fit "
          f"{host_s:.4f} s); peak {peak_gb:.2f} GB; launches {moved}; max "
          f"|tensor fit - array fit| {err:.3e}; top_features_ equal",
          flush=True)
    return fit_s


class RefitTuRF(TuRF):
    """TuRF without its fast scorers: the base estimator re-fits on the
    active columns every round, as the reference's loop does."""

    def _make_fast_scorer(self, base, X, y):
        return None


def turf_phase(dev, label, X, y, kind):
    """TuRF(MultiSURF()) with its device-resident fast scorer against the
    re-fitting loop on the card: one copy of X to the card (counted where
    the fits copy it, over the whole TuRF fit), the same selection.  Each
    runs twice, alternating, so that neither alone pays the process's
    first allocations at this shape."""
    kw = dict(n_features_to_select=10, pct_remove=0.5)
    fast_s, slow_s = [], []
    for _ in range(2):
        _relief_base.reset_upload_count()
        rd.reset_gemm_ops()
        before = launch_counts()
        fast, sec, peak_gb = timed_fit(dev, TuRF(MultiSURF(), **kw), X, y)
        fast_s.append(sec)
        uploads, ops = _relief_base.uploads, rd.gemm_ops
        moved = launches_since(before)
        _relief_base.reset_upload_count()
        slow, sec, _ = timed_fit(dev, RefitTuRF(MultiSURF(), **kw), X, y)
        slow_s.append(sec)
        slow_uploads = _relief_base.uploads
    err = float(np.abs(fast.feature_importances_
                       - slow.feature_importances_).max())
    final = float(np.abs(fast._final_scores_ - slow._final_scores_).max())
    rounds = fast._iteration_ + 1
    check(uploads == 1, f"{label}: X went to the card {uploads} times")
    check(slow_uploads == slow._iteration_ + 1,
          f"{label}: the re-fitting loop copied X {slow_uploads} times")
    mixed_moved = moved["relief_pass1_mixed"] + moved["relief_pass2_mixed"]
    if kind == "discrete":
        check(ops > 0 and not any(moved.values()),
              f"{label}: discrete engine ({ops} ops, launches {moved})")
    elif kind == "continuous":
        check(moved["relief_pass1_cont"] >= rounds
              and moved["relief_pass2_cont"] >= rounds and ops == 0,
              f"{label}: continuous kernels each round {moved}")
    else:
        check(ops > 0 and moved["relief_pass1_cont"] > 0
              and moved["relief_pass2_cont"] > 0 and mixed_moved == 0,
              f"{label}: hybrid engine ({ops} ops, launches {moved})")
    check(rounds == slow._iteration_ + 1, f"{label}: rounds")
    check(err <= TURF_ATOL and final <= TURF_ATOL,
          f"{label}: max |fast - refit| importances {err}, last round "
          f"{final}")
    check(np.array_equal(fast.top_features_, slow.top_features_),
          f"{label}: top_features_ {fast.top_features_} vs "
          f"{slow.top_features_}")
    print(f"{label}: TuRF(MultiSURF(), n_features_to_select=10, "
          f"pct_remove=0.5) X {X.shape[0]}x{X.shape[1]} {X.dtype}: "
          f"{rounds} rounds; fast scorer {fast_s[0]:.4f}, then "
          f"{fast_s[1]:.4f} s (X copied to the card {uploads} time, peak "
          f"{peak_gb:.2f} GB), re-fitting loop {slow_s[0]:.4f}, then "
          f"{slow_s[1]:.4f} s (X copied {slow_uploads} times); max "
          f"|importances fast - refit| {err:.3e}, last round {final:.3e}; "
          f"top_features_ {fast.top_features_.tolist()} equal", flush=True)


def chi2_phase(dev, n=2000, p=200000, c=5, meshes=()):
    """chi2 on a float32 tensor of counts on the card (by default the
    upstream benchmark's 2,000 x 200,000, counts 0..4, 5 classes) against
    the float64 host path; then, for each mesh of ``meshes`` (mesh-stats),
    ``sharded_chi2_stats`` on the same tensor against it."""
    gen = torch.Generator(device=dev).manual_seed(0)
    Xt = torch.randint(0, 5, (n, p), generator=gen, device=dev,
                       dtype=torch.float32)
    y = np.random.RandomState(0).randint(0, c, n)
    stats, pv = chi2(Xt, y)                       # first call
    dev_ms = cuda_ms(lambda: chi2(Xt, y), 3)
    sharded = [(mesh,) + mesh_timed(mesh, lambda: parallel.sharded_chi2_stats(
        Xt, y, c, devices=mesh)) for mesh in meshes]
    X = Xt.cpu().numpy()
    del Xt
    torch.cuda.empty_cache()
    t0 = time.perf_counter()
    want = chi2_stats_exact(X, y, c)
    host_s = time.perf_counter() - t0
    rel = float(np.max(np.abs(stats - want) / np.maximum(np.abs(want),
                                                         1e-300)))
    check(stats.shape == (p,) and np.isfinite(stats).all()
          and np.isfinite(pv).all(), "chi2: finite statistics")
    check(np.allclose(stats, want, rtol=CHI2_RTOL, atol=0),
          f"chi2: max relative difference {rel}")
    print(f"chi2: float32 tensor {n}x{p} counts, {c} classes on the card: "
          f"{dev_ms:.4f} ms a call (host array in float64: "
          f"{host_s * 1e3:.4f} ms); max relative difference to the float64 "
          f"host path {rel:.3e}", flush=True)
    for mesh, got, sec, peak in sharded:
        rel = float(np.max(np.abs(got - want) / np.maximum(np.abs(want),
                                                           1e-300)))
        check(np.allclose(got, want, rtol=CHI2_RTOL, atol=0),
              f"mesh-stats: sharded chi2 max relative difference {rel}")
        print(f"mesh-stats: sharded_chi2_stats on the {n}x{p} tensor, "
              f"{len(mesh)} shards ({mesh_name(mesh)}): {sec * 1e3:.4f} ms "
              f"(first call), peak {peak:.2f} GB; max relative difference "
              f"to the float64 host path {rel:.3e}", flush=True)
    return dev_ms, host_s


# ---------------------------------------------------------------------------
# mRMR and CFS on the contingency tables' int8 GEMMs
# ---------------------------------------------------------------------------

def selector_fit(dev, est, X, y):
    """One fit of an mRMR or CFS on the card: (est, seconds, peak device
    GB, int8 GEMM operations, host seconds of its greedy loop: mRMR's
    ``_greedy_select``, CFS's search and prune, column reads included)."""
    spent = [0.0]

    def timed(fn):
        def run_timed(*args):
            t0 = time.perf_counter()
            try:
                return fn(*args)
            finally:
                spent[0] += time.perf_counter() - t0
        return run_timed

    saved = (cfs_mod._best_first_search, cfs_mod._prune_redundant)
    cfs_mod._best_first_search, cfs_mod._prune_redundant = map(timed, saved)
    if isinstance(est, mRMR):
        est._greedy_select = timed(est._greedy_select)
    rd.reset_gemm_ops()
    try:
        est, sec, peak = timed_fit(dev, est, X, y)
    finally:
        cfs_mod._best_first_search, cfs_mod._prune_redundant = saved
        vars(est).pop("_greedy_select", None)
    return est, sec, peak, rd.gemm_ops, spent[0]


def selector_phase(dev, label, make, X, y, warm=1):
    """A first fit and ``warm`` more of ``make()`` on the card, checked to
    run int8 GEMMs and no Relief kernel; prints one line and returns the
    first fit's estimator and the timings."""
    before = launch_counts()
    fits = [selector_fit(dev, make(), X, y) for _ in range(1 + warm)]
    check(launch_counts() == before, f"{label}: no Relief kernel launched")
    check(all(f[3] > 0 for f in fits), f"{label}: int8 GEMMs ran")
    est, first_s, peak, ops, greedy_s = fits[0]
    warm_s = [f[1] for f in fits[1:]]
    rate = ops / min(f[1] for f in fits) / 1e12
    print(f"{label}: {type(est).__name__} X {X.shape[0]}x{X.shape[1]} "
          f"{X.dtype}; fit {first_s:.4f} s, warm "
          f"{', '.join(f'{t:.4f}' for t in warm_s)} s; gemm_ops "
          f"{ops:.4e} ({rate:.3f} TOP/s over the fastest fit, "
          f"{100 * rate / INT8_PEAK_TOPS:.3f}% of {INT8_PEAK_TOPS:.0f}); "
          f"peak {max(f[2] for f in fits):.3f} GB; greedy loop on the host "
          f"{', '.join(f'{f[4]:.4f}' for f in fits)} s; scikit-learn "
          f"{'present' if HAVE_SKLEARN else 'absent (stand-ins)'}",
          flush=True)
    return dict(est=est, first_s=first_s, warm_s=warm_s, gemm_ops=ops,
                peak_gb=max(f[2] for f in fits), greedy_s=greedy_s)


def with_threshold(module, name, value, fn):
    """fn() with ``module.name`` set to value (a streaming threshold)."""
    saved = getattr(module, name)
    setattr(module, name, value)
    try:
        return fn()
    finally:
        setattr(module, name, saved)


def plain_stat(xd, v, s, n, stat):
    """The statistic of every column of the codes xd (on the card) against
    v from the plain bincount tables, float32 numpy."""
    return ct.tables_stat(ct.feature_target_tables_ref(xd, v, s, s),
                          n, stat).cpu().numpy()


def mrmr_phase(dev, n=2000, p=5000):
    """14. mRMR(10) at the upstream mRMR grid's largest point, 2,000 x 5,000
    codes 0..4 with a binary y: the device-resident matrix path."""
    t0 = time.perf_counter()
    oracle = load_oracles()
    rng = np.random.RandomState(14)
    X = rng.randint(0, 5, (n, p))
    y = rng.randint(0, 2, n)
    res = selector_phase(dev, "mrmr", lambda: mRMR(n_features_to_select=10),
                         X, y)
    est = res["est"]
    R = est._redundancy_dev
    check(R is not None and R.device == dev and tuple(R.shape) == (p, p),
          "mrmr: the redundancy matrix stays on the card")
    miq = selector_fit(dev, mRMR(n_features_to_select=10, method="MIQ"),
                       X, y)
    check(len(set(miq[0].top_features_.tolist())) == 10, "mrmr: MIQ picks")
    stream = with_threshold(mrmr_mod, "FULL_REDUNDANCY_MAX_P", p // 5,
                            lambda: selector_fit(
                                dev, mRMR(n_features_to_select=10), X, y))
    check(stream[0].redundancy_matrix_ is None, "mrmr: streamed path")
    check(np.array_equal(stream[0].top_features_, est.top_features_),
          f"mrmr: streamed top_features_ {stream[0].top_features_} vs "
          f"{est.top_features_}")
    check(np.array_equal(stream[0].relevance_scores_,
                         est.relevance_scores_),
          "mrmr: streamed relevance equal bit for bit")
    X_enc = mrmr_mod._encode_union(X, y)[0]
    s = 5
    tile = ct.pair_tile(n, p, s)
    xt = ct.stage_codes(X_enc, s, dev)
    rd.reset_gemm_ops()
    got = ct.pair_tables(xt[:tile], xt[tile:2 * tile], n, s=s)
    check(rd.gemm_ops > 0, "mrmr: the pair tile is an int8 GEMM")
    want = ct.pair_tables_ref(X_enc[:, :tile], X_enc[:, tile:2 * tile], s=s,
                              device=dev)
    check(torch.equal(got, want), "mrmr: pair tile tables == plain tables")
    block = ct.tables_stat(want, n, "mi")
    check(torch.equal(R[:tile, tile:2 * tile], block),
          f"mrmr: a {tile}-column block of R == the plain tables' MI, bit "
          "for bit")
    del xt, got, want, block
    red = est.redundancy_matrix_
    pairs = [rng.choice(p, 2, replace=False) for _ in range(20)]
    err = max(abs(red[i, j] - oracle.mi_pair_bits(X_enc[:, i], X_enc[:, j]))
              for i, j in pairs)
    check(err <= ORACLE_ATOL_MI, f"mrmr: 20 pairs vs the oracle, err {err}")
    sec = time.perf_counter() - t0
    print(f"mrmr referees: MIQ fit {miq[1]:.4f} s; streamed path "
          f"(FULL_REDUNDANCY_MAX_P {p // 5}) {stream[1]:.4f} s, top_features_ "
          f"{est.top_features_.tolist()} equal, relevance equal bit for bit; "
          f"pair tile {tile}x{tile} tables == pair_tables_ref, its MI block "
          f"== R's bit for bit; 20 pairs vs tests/oracles.py max err "
          f"{err:.3e}; phase {sec:.2f} s", flush=True)
    return res, sec


def mrmr_stream_phase(dev, n=2000, p=50000):
    """15. mRMR(10) at upstream's GWAS-p point, 2,000 x 50,000 codes 0..4,
    past FULL_REDUNDANCY_MAX_P: columns stream against X staged once."""
    t0 = time.perf_counter()
    rng = np.random.RandomState(15)
    X = rng.randint(0, 5, (n, p))
    y = rng.randint(0, 2, n)
    res = selector_phase(dev, "mrmr-stream",
                         lambda: mRMR(n_features_to_select=10), X, y)
    est = res["est"]
    check(est.redundancy_matrix_ is None, "mrmr-stream: no (p, p) matrix")
    X_enc, y_enc, _ = mrmr_mod._encode_union(X, y)
    s = 5
    xd = torch.from_numpy(X_enc).to(dev)
    rel = plain_stat(xd, y_enc, s, n, "mi").astype(np.float64)
    rel_err = float(np.abs(rel - est.relevance_scores_).max())
    check(rel_err <= PLAIN_ATOL_MI, f"mrmr-stream: relevance err {rel_err}")
    staged = ct.StagedColumnStats(X_enc, s, device=dev)
    cols = {}

    def plain_col(j):
        if j not in cols:
            cols[j] = plain_stat(xd, xd[:, j], s, n, "mi").astype(np.float64)
            cols[j][j] = 0.0
        return cols[j]

    col_err = 0.0
    for j in est.top_features_:
        got = staged.column(j, "mi")
        got[j] = 0.0
        col_err = max(col_err, float(np.abs(got - plain_col(j)).max()))
    check(col_err <= PLAIN_ATOL_MI, f"mrmr-stream: column err {col_err}")
    again = mRMR(n_features_to_select=10)
    again.n_features_in_ = p
    sel = again._greedy_select(rel, plain_col)
    check(np.array_equal(sel, est.top_features_),
          f"mrmr-stream: greedy over the plain columns {sel} vs "
          f"{est.top_features_}")
    del xd, staged
    sec = time.perf_counter() - t0
    print(f"mrmr-stream referees: relevance and the 10 selected columns vs "
          f"feature_target_tables_ref on the card, max err {rel_err:.3e}, "
          f"{col_err:.3e}; the greedy over them selects "
          f"{est.top_features_.tolist()} again; phase {sec:.2f} s",
          flush=True)
    return res, sec


def cfs_phase(dev, n=5000, p=2000):
    """16. CFS() (uniform, 10 bins) on make_classification(5,000 x 2,000,
    n_informative=10, random_state=11) with column 0 = y + N(0, 0.1) and
    column 1 its copy + N(0, 0.05): the device-resident SU matrix."""
    t0 = time.perf_counter()
    oracle = load_oracles()
    X, y = make_classification(n_samples=n, n_features=p,
                               n_informative=10, random_state=11)
    rng = np.random.RandomState(16)
    X[:, 0] = y + rng.normal(0, 0.1, n)
    X[:, 1] = X[:, 0] + rng.normal(0, 0.05, n)
    res = selector_phase(dev, "cfs", CFS, X, y)
    est = res["est"]
    sel = est.selected_indices_
    check(est.effective_backend_ == dev.type, "cfs: effective_backend_")
    check(len(sel) > 0 and 0 in sel and 1 not in sel,
          f"cfs: selection {sel} holds 0 and not its copy 1")
    stream = with_threshold(cfs_mod, "FULL_SU_MAX_P", p // 2,
                            lambda: selector_fit(dev, CFS(), X, y))
    check(np.array_equal(stream[0].selected_indices_, sel),
          f"cfs: streamed selection {stream[0].selected_indices_}")
    merit_err = abs(stream[0].merit_ - est.merit_)
    check(merit_err <= 1e-6, f"cfs: streamed merit err {merit_err}")
    X_enc, n_states = cfs_mod._encode(X, 10, "uniform")
    s = int(max(n_states.max(), len(np.unique(y))))
    R = ct.pairwise_stat_matrix_device(X_enc, s, "su", device=dev)[0]
    pairs = [rng.choice(p, 2, replace=False).tolist() for _ in range(20)]
    err = max(abs(float(R[i, j]) - oracle.su_pair(X_enc[:, i], X_enc[:, j]))
              for i, j in pairs)
    check(err <= ORACLE_ATOL_MI, f"cfs: 20 pairs vs the oracle, err {err}")
    del R
    sec = time.perf_counter() - t0
    print(f"cfs referees: selected {sel.tolist()}, merit {est.merit_:.6f}; "
          f"streamed path (FULL_SU_MAX_P {p // 2}) {stream[1]:.4f} s, equal "
          f"selection, merit err {merit_err:.3e}; 20 SU pairs vs "
          f"tests/oracles.py max err {err:.3e}; phase {sec:.2f} s",
          flush=True)
    return res, sec


def cfs_stream_phase(dev, n=2000, p=20000):
    """17. CFS() on 2,000 x 20,000 planted genotypes, past FULL_SU_MAX_P:
    SU columns stream; search and prune rerun over the plain tables."""
    t0 = time.perf_counter()
    X, y = planted_genotypes(12, n, p, 2)
    res = selector_phase(dev, "cfs-stream", CFS, X, y)
    est = res["est"]
    X_enc, n_states = cfs_mod._encode(X, 10, "uniform")
    y_enc = np.unique(y, return_inverse=True)[1]
    s = int(max(n_states.max(), y_enc.max() + 1))
    xd = torch.from_numpy(X_enc).to(dev)
    r_cf = plain_stat(xd, y_enc, s, n, "su")
    cols = {}

    def plain_col(j):
        j = int(j)
        if j not in cols:
            cols[j] = plain_stat(xd, xd[:, j], s, n, "su")
            cols[j][j] = 0.0
        return cols[j]

    sel = np.sort(np.asarray(cfs_mod._best_first_search(r_cf, plain_col),
                             dtype=int))
    sel = np.sort(np.asarray(cfs_mod._prune_redundant(sel, r_cf, plain_col),
                             dtype=int))
    check(np.array_equal(sel, est.selected_indices_),
          f"cfs-stream: {est.selected_indices_} vs plain {sel}")
    check(0 in sel, "cfs-stream: the 60% plant (column 0) is selected")
    del xd
    sec = time.perf_counter() - t0
    print(f"cfs-stream referees: search and prune over the plain r_cf and "
          f"SU columns select {sel.tolist()} again (merit "
          f"{est.merit_:.6f}); phase {sec:.2f} s", flush=True)
    return res, sec


# ---------------------------------------------------------------------------
# MDR on the tables' int8 GEMMs
# ---------------------------------------------------------------------------

def planted_interaction(seed, n, p, k, flip=0.1):
    """Genotypes 0..2 drawn uniform by ``RandomState(seed)`` and a pure
    k-locus interaction with no marginal effect, y = [(sum of the k
    planted columns) mod 3 == 0], a share ``flip`` of the labels flipped:
    (X uint8, y, the planted columns as a sorted tuple)."""
    rng = np.random.RandomState(seed)
    X = rng.randint(0, 3, (n, p)).astype(np.uint8)
    planted = tuple(sorted(int(c) for c in rng.choice(p, k, replace=False)))
    y = (X[:, planted].astype(np.int64).sum(1) % 3 == 0).astype(np.int64)
    y[rng.rand(n) < flip] ^= 1
    return X, y, planted


def combo_rank(p, combo):
    """Lexicographic rank of a sorted combo among C(p, len(combo))."""
    k, rank, prev = len(combo), 0, -1
    for i, c in enumerate(combo):
        rank += sum(math.comb(p - v - 1, k - i - 1)
                    for v in range(prev + 1, c))
        prev = c
    return rank


def mdr_fit(dev, est, X, y):
    """One MDR fit on the card, with the scorer's staging and its search
    timed apart (each up to a device sync): a dict of the estimator, the
    fit's seconds, peak device GB, int8 GEMM operations and the seconds of
    the staging, the search and the rest (folds, lookup tables, held-out
    BAs) on the host."""
    spent = {"stage": 0.0, "search": 0.0}
    cls = mdr_op.MDRFoldScorer
    saved = cls.__init__, cls.search

    def timed(name, fn):
        def run_timed(*args, **kw):
            t0 = time.perf_counter()
            try:
                return fn(*args, **kw)
            finally:
                torch.cuda.synchronize()
                spent[name] += time.perf_counter() - t0
        return run_timed

    cls.__init__, cls.search = timed("stage", saved[0]), timed(
        "search", saved[1])
    rd.reset_gemm_ops()
    try:
        est, sec, peak = timed_fit(dev, est, X, y)
    finally:
        cls.__init__, cls.search = saved
    return dict(est=est, sec=sec, peak_gb=peak, gemm_ops=rd.gemm_ops,
                stage_s=spent["stage"], search_s=spent["search"],
                host_s=sec - spent["stage"] - spent["search"])


def mdr_run(dev, label, make, X, y, planted, warm=1):
    """A first fit and ``warm`` more of ``make()`` on the card, checked to
    run int8 GEMMs and no Relief kernel and to find ``planted`` in every
    fold; prints one line (times, GEMM operations and rate, the one-hots'
    HBM floor, peak memory) and returns the first fit's estimator, its
    GEMM operations and the fits' seconds."""
    before = launch_counts()
    fits = [mdr_fit(dev, make(), X, y) for _ in range(1 + warm)]
    est = fits[0]["est"]
    check(launch_counts() == before, f"{label}: no Relief kernel launched")
    check(all(f["gemm_ops"] > 0 for f in fits), f"{label}: int8 GEMMs ran")
    check(est.effective_backend_ == dev.type,
          f"{label}: effective_backend_ {est.effective_backend_}")
    check(est.best_interaction_ == planted and est.best_cvc_ == 5,
          f"{label}: best {est.best_interaction_} CVC {est.best_cvc_}, "
          f"planted {planted}")
    n, p = X.shape
    k = est.k
    n_combos = math.comb(p, k)
    fast = min(fits, key=lambda f: f["search_s"])
    floor_s = (2 * n_combos * 3 ** k * mdr_op._round_up(n, 8)
               / HBM_BYTES_PER_S)
    rate = fits[0]["gemm_ops"] / min(f["sec"] for f in fits) / 1e12
    # the operations that do work: the 2F fold-weight rows of A (the GEMM
    # pads them to 32) times every real combo's 3^k one-hot rows over n
    useful = 2 * (2 * est.cv) * n * 3 ** k * n_combos
    useful_rate = useful / min(f["sec"] for f in fits) / 1e12

    def secs(key):
        return ", ".join(f"{f[key]:.4f}" for f in fits)

    print(f"{label}: MDR(k={k}, cv=5) X {n}x{p} ({n_combos} combos, "
          f"{3 ** k} cells); best {est.best_interaction_} CVC "
          f"{est.best_cvc_}/5, mean held-out BA "
          f"{est.best_mean_testing_ba_:.4f}; fit"
          f"{' (first, warm)' if warm else ''} {secs('sec')} s; search "
          f"{secs('search_s')} s, staging {secs('stage_s')} s, host outside "
          f"them {secs('host_s')} s; "
          f"gemm_ops {fits[0]['gemm_ops']:.4e} ({rate:.3f} TOP/s over the "
          f"fastest fit, {100 * rate / INT8_PEAK_TOPS:.3f}% of "
          f"{INT8_PEAK_TOPS:.0f}), useful operations {useful:.4e} "
          f"(2*2F*n*3^k*C(p,k): {useful_rate:.3f} TOP/s, "
          f"{100 * useful_rate / INT8_PEAK_TOPS:.3f}%); one-hot HBM floor "
          f"{floor_s:.4f} s = "
          f"{100 * floor_s / fast['search_s']:.1f}% of the fastest search; "
          f"peak {max(f['peak_gb'] for f in fits):.3f} GB; scikit-learn "
          f"{'present' if HAVE_SKLEARN else 'absent (stand-ins)'}",
          flush=True)
    return dict(est=est, first_s=fits[0]["sec"],
                warm_s=[f["sec"] for f in fits[1:]],
                gemm_ops=fits[0]["gemm_ops"])


def mdr_folds(est, X, y):
    """The folds and 0/1 fold weights an MDR fit of ``est`` takes."""
    splits = list(StratifiedKFold(n_splits=est.cv, shuffle=True,
                                  random_state=42).split(X, y))
    return (splits,) + est._fold_weights(y, splits)


def oracle_ba(X, y, combo):
    """float64 balanced accuracy of a combo's MDR model on (X, y), by the
    high-risk rule of tests/test_mdr.py:287-301."""
    k = len(combo)
    cells = X[:, list(combo)].astype(np.int64) @ (3 ** np.arange(
        k - 1, -1, -1))
    case = np.bincount(cells[y == 1], minlength=3 ** k).astype(np.float64)
    ctrl = np.bincount(cells[y != 1], minlength=3 ** k).astype(np.float64)
    P, N = case.sum(), ctrl.sum()
    high = (ctrl == 0) | (case / np.maximum(ctrl, 1e-30) > P / N)
    return (case[high].sum() / P + ctrl[~high].sum() / N) / 2


def heldout_ba(X, y, train, test, combo):
    """Held-out BA of a combo: its lookup table from the training fold
    (case / (control + 1e-9) above the fold's case/control ratio),
    predicted on the test fold, sensitivity and specificity averaged (a
    class absent from the test fold counts 0)."""
    k = len(combo)
    w = 3 ** np.arange(k - 1, -1, -1)
    cells = X[:, list(combo)].astype(np.int64) @ w
    yt = y[train]
    case = np.bincount(cells[train][yt == 1], minlength=3 ** k)
    ctrl = np.bincount(cells[train][yt != 1], minlength=3 ** k)
    lut = case / (ctrl + 1e-9) > case.sum() / ctrl.sum()
    pred, truth = lut[cells[test]], y[test] == 1
    sens = (pred & truth).sum() / truth.sum() if truth.any() else 0.0
    spec = (~pred & ~truth).sum() / (~truth).sum() if (~truth).any() else 0.0
    return 0.5 * (float(sens) + float(spec))


def ref_search(dev, X, w_case, w_ctrl, k):
    """Each fold's (best rank, best key) of a full search over the plain
    bincount tables (``mdr_tables_ref``) on ``dev``, keyed on the host:
    high-risk cells by the float64 rule of tests/test_mdr.py:287-301, the
    key tp*N + tn*P in int64, the first maximum."""
    p = X.shape[1]
    combos = mdr_op.unrank_combos(p, k, 0, math.comb(p, k))
    t = mdr_op.mdr_tables_ref(X, w_case, w_ctrl, combos, k,
                              device=dev).cpu().numpy()
    ranks, keys = [], []
    for f in range(w_case.shape[0]):
        case, ctrl = t[0, f], t[1, f]
        P, N = int(w_case[f].sum()), int(w_ctrl[f].sum())
        high = (ctrl == 0) | (case / np.maximum(ctrl, 1e-30) > P / N)
        key = (case * high).sum(1) * N + (ctrl * ~high).sum(1) * P
        ranks.append(int(np.argmax(key)))
        keys.append(int(key[ranks[-1]]))
    return np.asarray(ranks, np.int64), np.asarray(keys, np.int64)


def f64_winners(X, y, splits):
    """Each training fold's k = 2 winner by the float64 host oracle (the
    rule of tests/test_mdr.py:287-301, the first maximum in lexicographic
    order), every pair's 3 x 3 tables of a class from the Gram matrix of
    its samples' float64 one-hots."""
    p = X.shape[1]
    a, b = mdr_op.unrank_combos(p, 2, 0, math.comb(p, 2)).T
    winners = []
    for train, _ in splits:
        hot = (X[train][:, :, None] == np.arange(3)).reshape(len(train), -1)
        hot = hot.astype(np.float64)
        is_case = y[train] == 1
        case, ctrl = ((h.T @ h).reshape(p, 3, p, 3)[a, :, b, :].reshape(
            -1, 9) for h in (hot[is_case], hot[~is_case]))
        P, N = float(is_case.sum()), float((~is_case).sum())
        high = (ctrl == 0) | (case / np.maximum(ctrl, 1e-30) > P / N)
        ba = ((case * high).sum(1) / P + (ctrl * ~high).sum(1) / N) / 2
        i = int(np.argmax(ba))
        winners.append((int(a[i]), int(b[i])))
    return winners


def chunk_tables_check(dev, label, scorer, X, w_case, w_ctrl, p, chunks):
    """For each chunk start in ``chunks`` of a search over C(p, k): the
    ranks the search scores, unranked on the device, equal
    ``unrank_combos`` (a padded tail repeating the last combo), and the
    GEMM tables of those combos equal ``mdr_tables_ref``'s.  Returns
    (combos a chunk, combos checked)."""
    k = scorer.k
    n_combos = math.comb(p, k)
    _, m = scorer.chunk_plan(n_combos, mdr_mod._COMBO_CHUNK)
    tables = torch.from_numpy(mdr_op._comb_tables(p, k)).to(dev)
    checked = 0
    for r0 in chunks:
        combos = mdr_op._unrank_device(scorer.chunk_ranks(r0, m, n_combos),
                                       tables, k=k)
        real = min(m, n_combos - r0)
        want = mdr_op.unrank_combos(p, k, r0, r0 + real)
        want = np.vstack([want, np.repeat(want[-1:], m - real, axis=0)])
        check(np.array_equal(combos.cpu().numpy(), want),
              f"{label}: device-unranked chunk at rank {r0}")
        got = scorer.tables(combos)
        ref = mdr_op.mdr_tables_ref(X, w_case, w_ctrl, combos, k,
                                    device=dev)
        check(torch.equal(got.to(torch.int64), ref),
              f"{label}: GEMM tables == mdr_tables_ref at rank {r0}")
        checked += m
        del combos, got, ref
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return m, checked


def mdr_phase(dev, n=2000, p=200, n_large=120000, p_large=30):
    """18. MDR(k=2, cv=5) on 2,000 x 200 planted genotypes (the upstream
    MDR grid's largest k = 2 point), then mdr-large-n at 120,000 x 30."""
    t0 = time.perf_counter()
    X, y, planted = planted_interaction(18, n, p, 2)
    res = mdr_run(dev, "mdr", lambda: MDR(k=2, cv=5), X, y, planted)
    est = res["est"]
    splits, w_case, w_ctrl = mdr_folds(est, X, y)
    scorer = mdr_op.MDRFoldScorer(X, w_case, w_ctrl, 2, device=dev)
    _, keys, ranks = scorer.search(p, math.comb(p, 2),
                                   chunk=mdr_mod._COMBO_CHUNK)
    ref_ranks, ref_keys = ref_search(dev, X, w_case, w_ctrl, 2)
    check(np.array_equal(ranks, ref_ranks) and np.array_equal(keys,
                                                              ref_keys),
          f"mdr: GEMM search ranks {ranks} keys {keys} vs plain tables' "
          f"{ref_ranks} {ref_keys}")
    del scorer
    Xl, yl, planted_l = planted_interaction(181, n_large, p_large, 2)
    large = mdr_run(dev, "mdr-large-n", lambda: MDR(k=2, cv=5), Xl, yl,
                    planted_l, warm=0)
    splits_l = mdr_folds(large["est"], Xl, yl)[0]
    oracle = f64_winners(Xl, yl, splits_l)
    check(oracle == large["est"]._fold_best,
          f"mdr-large-n: fold winners {large['est']._fold_best} vs float64 "
          f"oracle {oracle}")
    n_train = len(splits_l[0][0])
    sec = time.perf_counter() - t0
    print(f"mdr referees: every fold's best rank and key == a full search "
          f"over mdr_tables_ref keyed in numpy ({math.comb(p, 2)} combos, "
          f"keys "
          f"{keys.tolist()}); mdr-large-n's {len(splits_l)} fold winners "
          f"(training folds of {n_train}) == the float64 oracle's; phase "
          f"{sec:.2f} s", flush=True)
    return res, large, sec


def mdr_k3_phase(dev, n=1000, p=500):
    """19. MDR(k=3, cv=5) on 1,000 x 500 (20,708,500 combos) with a planted
    3-locus interaction, first and warm; four chunks' combos and tables
    against the plain ones, and the fold winners against numpy oracles."""
    t0 = time.perf_counter()
    oracle = load_oracles()
    X, y, planted = planted_interaction(19, n, p, 3)
    res = mdr_run(dev, "mdr-k3", lambda: MDR(k=3, cv=5), X, y, planted)
    est = res["est"]
    splits, w_case, w_ctrl = mdr_folds(est, X, y)
    scorer = mdr_op.MDRFoldScorer(X, w_case, w_ctrl, 3, device=dev)
    n_combos = math.comb(p, 3)
    _, m = scorer.chunk_plan(n_combos, mdr_mod._COMBO_CHUNK)
    last = (n_combos - 1) // m * m
    chunks = sorted({0, combo_rank(p, planted) // m * m, max(last - m, 0),
                     last})
    m, checked = chunk_tables_check(dev, "mdr-k3", scorer, X, w_case, w_ctrl,
                                    p, chunks)
    vals, keys, ranks = scorer.search(p, n_combos,
                                      chunk=mdr_mod._COMBO_CHUNK)
    res.update(keys=keys, ranks=ranks, X=X, y=y, planted=planted)
    del scorer
    rng = np.random.RandomState(20)
    sample = [tuple(np.sort(rng.choice(p, 3, replace=False)))
              for _ in range(2000)]
    ba_err = ho_err = 0.0
    for f, (train, test) in enumerate(splits):
        win = est._fold_best[f]
        check(tuple(mdr_op.unrank_combos(p, 3, int(ranks[f]),
                                         int(ranks[f]) + 1)[0]) == win,
              f"mdr-k3: fold {f} search winner")
        want = oracle.mdr_balanced_accuracy(X[train], y[train], win)
        ba_err = max(ba_err, abs(vals[f] - want))
        ho_err = max(ho_err, abs(est._fold_test_ba[f]
                                 - heldout_ba(X, y, train, test, win)))
        beaten = max(oracle_ba(X[train], y[train], c) for c in sample)
        check(beaten <= want, f"mdr-k3: fold {f}: a sampled combo's BA "
              f"{beaten} beats the winner's {want}")
    check(ba_err <= MDR_BA_ATOL, f"mdr-k3: winners' BA vs oracle {ba_err}")
    check(ho_err <= 1e-12, f"mdr-k3: held-out BAs vs oracle {ho_err}")
    sec = time.perf_counter() - t0
    print(f"mdr-k3 referees: chunks of {m} at ranks {chunks} (the last "
          f"padded by {last + m - n_combos}): "
          f"device-unranked combos == unrank_combos and GEMM tables == "
          f"mdr_tables_ref ({checked} combos x 5 folds x 2 classes x 27 "
          f"cells); fold winners' BA vs tests/oracles.py max err "
          f"{ba_err:.3e}, held-out BA vs numpy {ho_err:.3e}, none of 2,000 "
          f"sampled combos beats a winner; phase {sec:.2f} s", flush=True)
    return res, sec


def mdr_k4_phase(dev, n=1000, p=100):
    """20. MDR(k=4, cv=5) on 1,000 x 100 (3,921,225 combos, 81 cells) with
    a planted 4-locus interaction; the tail chunk's tables against the
    plain ones."""
    t0 = time.perf_counter()
    X, y, planted = planted_interaction(20, n, p, 4)
    res = mdr_run(dev, "mdr-k4", lambda: MDR(k=4, cv=5), X, y, planted,
                  warm=0)
    splits, w_case, w_ctrl = mdr_folds(res["est"], X, y)
    scorer = mdr_op.MDRFoldScorer(X, w_case, w_ctrl, 4, device=dev)
    n_combos = math.comb(p, 4)
    _, m = scorer.chunk_plan(n_combos, mdr_mod._COMBO_CHUNK)
    last = (n_combos - 1) // m * m
    chunk_tables_check(dev, "mdr-k4", scorer, X, w_case, w_ctrl, p, [last])
    del scorer
    sec = time.perf_counter() - t0
    print(f"mdr-k4 referees: the tail chunk (ranks {last}.., {m} combos, "
          f"{last + m - n_combos} padded): device-unranked combos == "
          f"unrank_combos and GEMM tables == mdr_tables_ref; phase "
          f"{sec:.2f} s", flush=True)
    return res, sec


# ---------------------------------------------------------------------------
# Phase 24: the GWAS-scale route (packed codes, v2-promote, v2-gather)
# ---------------------------------------------------------------------------

class RouteSpy:
    """Within the block, the v2 routes the discrete engine took, in order:
    'resident' (``_apply_layout``), 'promote' and 'gather-<bits>' (0 for
    int8 codes)."""

    NAMES = {"_apply_layout": "resident", "_promote_packed_sorted": "promote",
             "_run_v2_gather": "gather"}

    def __enter__(self):
        self.seen = []
        self.saved = {name: getattr(rd, name) for name in self.NAMES}
        for name, route in self.NAMES.items():
            setattr(rd, name, self._spy(name, route))
        return self

    def _spy(self, name, route):
        def spied(*a, **k):
            if route == "gather":
                codes = a[0]
                bits = codes.bits if isinstance(codes, rd.PackedCodes) else 0
                self.seen.append(f"gather-{bits}")
            else:
                self.seen.append(route)
            return self.saved[name](*a, **k)
        return spied

    def __exit__(self, *exc):
        for name, fn in self.saved.items():
            setattr(rd, name, fn)


def close(label, got, ref):
    """Check got against ref within GWAS_TOL; the largest difference."""
    atol, rtol = GWAS_TOL
    err = float(np.abs(got - ref).max())
    check(np.allclose(got, ref, atol=atol, rtol=rtol),
          f"{label}: max |scores - reference| {err} past atol {atol}, "
          f"rtol {rtol}")
    return err


def pack_checks(dev, n=300, p=1001, seed=24):
    """The pack and window functions on the card against their CPU
    versions, byte for byte: 2- and 4-bit codes, a ragged p, gathered
    rows, a window of every kind (first, inner, the ragged last, widened
    for the GEMM), the match counts of packed codes and the promote
    layout.  Returns the number of tensors compared."""
    rng = np.random.RandomState(seed)
    compared = 0

    def same(a, b, what):
        nonlocal compared
        check(a.dtype == b.dtype and torch.equal(a.cpu(), b.cpu()),
              f"pack on the card: {what} differs from the CPU's")
        compared += 1

    for s in (3, 9):
        codes = rng.randint(0, s, (n, p)).astype(np.int8)
        host = rd.stage_codes_packed(codes, s)
        card = rd.stage_codes_packed(codes, s, dev)
        same(card.packed, host.packed, f"{s} states: packed bytes")
        chunks = (torch.from_numpy(codes[r0:r0 + 64]).to(dev)
                  for r0 in range(0, n, 64))
        drawn = rd.stage_codes_packed(chunks, s, dev, shape=(n, p))
        same(drawn.packed, host.packed, f"{s} states: packed by row chunks")
        bits, per = host.bits, host.per
        rows = rng.permutation(n)[:n // 16 * 8]   # the GEMM's multiple of 8
        rows_h, rows_d = torch.from_numpy(rows), torch.from_numpy(rows).to(dev)
        w = 32 * per
        last = host.p_eff - per * 5
        for off, width in ((0, w), (per * 7, w), (last, per * 5)):
            for r_h, r_d in ((None, None), (rows_h, rows_d)):
                ref = rd._codes_window(host.packed, off, width, bits, r_h)
                same(rd._codes_window(card.packed, off, width, bits, r_d),
                     ref, f"{s} states: window at {off} of {width}")
                # widened for the GEMM on the card with code -1
                win = rd._gemm_window(card.packed, off, width, bits, r_d)
                check(dev.type != "cuda" or win.shape[1] % 8 == 0,
                      f"{s} states: GEMM window width {win.shape[1]}")
                same(win, torch.nn.functional.pad(
                    ref, (0, win.shape[1] - width), value=-1),
                     f"{s} states: GEMM window at {off} of {width}")
        ci_h, ci_d = host.packed[rows_h[:40]], card.packed[rows_d[:40]]
        same(rd._match_rows(ci_d, card.packed, 64, s, bits, rows_d),
             rd._match_rows(ci_h, host.packed, 64, s, bits, rows_h),
             f"{s} states: packed match counts")
        perm = np.argsort(rng.randint(0, 2, n), kind="stable")
        p_pad = rd._round_up(p, 128)
        same(rd._promote_packed_sorted(card, perm, n + 12, p_pad),
             rd._promote_packed_sorted(host, perm, n + 12, p_pad),
             f"{s} states: promoted layout")
    return compared


def forced_fits(dev, label, X, y, route, warm=1):
    """``MultiSURF(n_features_to_select=10).fit(X, y)``, first and ``warm``
    more: each must take ``route`` and launch no fused kernel.  Returns
    (estimator, seconds of each fit, int8 ops of the first, peak GB, the
    first fit's ``relief_discrete`` phase records)."""
    before = launch_counts()
    times, peaks, ops, records = [], [], 0, None
    for i in range(1 + warm):
        rd.reset_gemm_ops()
        with RouteSpy() as spy, PhaseRecords("relief_discrete.",
                                             on=not i) as rec:
            est, sec, peak = timed_fit(dev, MultiSURF(n_features_to_select=10),
                                       X, y)
        if not i:
            records = rec
        check(spy.seen == [route], f"{label}: routes {spy.seen}, expected "
              f"[{route!r}]")
        ops = ops or rd.gemm_ops
        times.append(sec)
        peaks.append(peak)
    moved = launches_since(before)
    check(not any(moved.values()), f"{label}: fused launches {moved}")
    check(ops > 0, f"{label}: no int8 GEMM ran")
    check(est.effective_backend_ == dev.type, f"{label}: effective_backend_")
    return est, times, ops, max(peaks), records


def headline_routes(dev, X, y, head):
    """Phase 7's genotypes through the three forced routes, each held to
    phase 7's scores and ``top_features_``: the host array with the sort
    budget at 0 (staged packed, then promoted), the same with the promote
    budget at 0 too (gathered from packed codes), and an int8 tensor on
    the card with the sort budget at 0 (gathered, bits 0)."""
    n, p = X.shape
    y_enc = np.unique(y, return_inverse=True)[1]
    ref = head["scores"]
    out = {}
    cases = (("snp-promote", "v2-promote", "host", "promote", False),
             ("snp-gather-packed", "v2-gather", "host", "gather-2", True),
             ("snp-gather-int8", "v2-gather", "tensor", "gather-0", False))
    for label, tier, source, route, no_promote in cases:
        data = X if source == "host" else torch.from_numpy(X).to(dev)

        def run():
            got = rd.discrete_tier(n, p, 3, y_enc, "multisurf", device=dev,
                                   source=source)
            check(got == tier, f"{label}: tier {got}, expected {tier}")
            return forced_fits(dev, label, data, y, route)

        def budgets():
            if no_promote:
                return with_threshold(rd, "_PACKED_PROMOTE_BUDGET", 0, run)
            return run()
        est, times, ops, peak, _ = with_threshold(
            rd, "_DEVICE_SORT_BUDGET", 0, budgets)
        del data
        torch.cuda.empty_cache()
        err = close(label, est.feature_importances_, ref)
        check(np.array_equal(est.top_features_,
                             np.argsort(ref)[::-1][:10]),
              f"{label}: top_features_ {est.top_features_}")
        print(f"{label}: MultiSURF X {n}x{p} int8 ({source}) tier {tier} "
              f"route {route}; fit {times[0]:.4f} s, warm "
              f"{', '.join(f'{t:.4f}' for t in times[1:])} s (phase 7: "
              f"{head['first_s']:.4f} s, warm "
              f"{', '.join(f'{t:.4f}' for t in head['warm_s'])} s); gemm_ops "
              f"{ops:.4e}; peak {peak:.2f} GB; max |scores - phase 7| "
              f"{err:.3e}; top_features_ equal", flush=True)
        out[label] = dict(first_s=times[0], warm_s=times[1:], peak_gb=peak,
                          err=err)
    return out


def balanced_labels(n, seed):
    return np.random.RandomState(seed).permutation(np.arange(n) % 2)


def gwas_promote_phase(dev, n=6000, p=2_600_000, seed=24):
    """gwas-promote: (n, p) int8 host genotypes (drawn on the card, copied
    to the host; column 0 = 2y) past the card's packed-staging gate and
    under its promote gate.  ``MultiSURF(n_features_to_select=10).fit``
    must take v2-promote and peak under 3 n p bytes, and equal the
    resident route on the same array (the sort budget raised)."""
    t0 = time.perf_counter()
    y = balanced_labels(n, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    Xd = torch.randint(0, 3, (n, p), generator=gen, device=dev,
                       dtype=torch.int8)
    Xd[:, 0] = torch.as_tensor(2 * y, dtype=torch.int8, device=dev)
    X = Xd.cpu().numpy()
    del Xd
    torch.cuda.empty_cache()
    data_s = time.perf_counter() - t0
    tier = rd.discrete_tier(n, p, 3, y, "multisurf", device=dev)
    check(tier == "v2-promote", f"gwas-promote: tier {tier}")
    est, times, ops, peak, rec = forced_fits(dev, "gwas-promote", X, y,
                                             "promote", warm=0)
    check(peak * 1e9 < 3 * n * p,
          f"gwas-promote: peak {peak:.2f} GB not under 3 n p")
    check(est.top_features_[0] == 0, "gwas-promote: column 0 ranks first")
    ref, ref_times, _, ref_peak, ref_rec = with_threshold(
        rd, "_DEVICE_SORT_BUDGET", 1 << 62,
        lambda: forced_fits(dev, "gwas-promote resident", X, y, "resident",
                            warm=0))
    del X
    torch.cuda.empty_cache()
    err = close("gwas-promote", est.feature_importances_,
                ref.feature_importances_)
    check(np.array_equal(est.top_features_, ref.top_features_),
          f"gwas-promote: top_features_ {est.top_features_} vs "
          f"{ref.top_features_}")
    rate = ops / times[0] / 1e12
    print(f"gwas-promote: MultiSURF X {n}x{p} int8 (host, drawn on the card "
          f"in {data_s:.2f} s) tier v2-promote; fit {times[0]:.4f} s "
          f"({rec.summary()}), gemm_ops {ops:.4e} ({rate:.1f} TOP/s), peak "
          f"{peak:.2f} GB (3 n p = {3 * n * p / 1e9:.2f}); resident route "
          f"{ref_times[0]:.4f} s ({ref_rec.summary()}), peak {ref_peak:.2f} "
          f"GB; max |promote - resident| {err:.3e}; top_features_ equal",
          flush=True)
    return dict(first_s=times[0], gemm_ops=ops, tops=rate, peak_gb=peak,
                phases=rec.records, resident_s=ref_times[0],
                resident_phases=ref_rec.records, resident_peak_gb=ref_peak,
                err=err)


def plain_unpack(packed, per):
    """The codes of packed bytes, ``per`` a byte, by integer arithmetic
    alone (code i of a byte is (byte // base**i) % base)."""
    base = 1 << (8 // per)
    byt = packed.to(torch.int16)
    vals = torch.stack([(byt // base ** i) % base for i in range(per)], -1)
    return vals.reshape(byt.shape[0], -1).to(torch.int8)


def gwas_referee(dev, pk, y, feats, ti, chunk=65536):
    """The scores (divided by n) of the features ``feats`` of packed
    codes, not through the engine.  The codes are unpacked a chunk of
    features at a time by :func:`plain_unpack`, the match counts come from
    an int8 one-hot GEMM of the referee's own, and D keeps the engine's
    focal blocks of ``ti`` rows and its class-sorted column order, so that
    the weight rules' float32 row statistics see the engine's D.  W comes
    from ``pair_weight_rules``, the one function the referee shares with
    the engine; the scores are sum_ij W_ij [x_if != x_jf] in float64."""
    n, per = pk.n, pk.per
    n_pad = -(-n // ti) * ti
    perm = np.argsort(y, kind="stable")
    rows = torch.as_tensor(perm, device=dev)
    sel = np.asarray(sorted(feats))
    xsel = torch.full((n_pad, len(sel)), -1, dtype=torch.int8, device=dev)
    match = torch.zeros((n_pad, n_pad), dtype=torch.int32, device=dev)
    for c0 in range(0, pk.p_eff, chunk):
        c1 = min(c0 + chunk, pk.p_eff)
        a = torch.full((n_pad, c1 - c0), -1, dtype=torch.int8, device=dev)
        a[:n] = plain_unpack(pk.packed[:, c0 // per:c1 // per][rows], per)
        hot = torch.cat([(a == s).to(torch.int8) for s in range(3)], 1)
        hot = torch.nn.functional.pad(hot, (0, (-hot.shape[1]) % 8))
        for b0 in range(0, n_pad, ti):
            match[b0:b0 + ti] += torch._int_mm(hot[b0:b0 + ti], hot.t())
        here = (sel >= c0) & (sel < c1)
        xsel[:, torch.as_tensor(np.flatnonzero(here), device=dev)] = a[
            :, torch.as_tensor(sel[here] - c0, device=dev)]
    yv = torch.full((n_pad,), -1, dtype=torch.int64, device=dev)
    yv[:n] = torch.as_tensor(np.asarray(y)[perm], device=dev)
    valid = (yv >= 0).to(torch.float32)
    n_real = torch.tensor(float(n), device=dev)
    cp = torch.zeros(1, device=dev)
    hot64 = [(xsel == s).to(torch.float64) for s in range(3)]
    score = torch.zeros(len(sel), dtype=torch.float64, device=dev)
    for b0 in range(0, n_pad, ti):
        blk = slice(b0, b0 + ti)
        D = (pk.p_eff - match[blk]).to(torch.float32)
        rules = relief_mod.pair_weight_rules(
            D, yv[blk], valid[blk], torch.arange(b0, b0 + ti, device=dev),
            yv, valid, n_real, cp, algo="multisurf", use_star=False, k=0)
        W = sum(r.double()[:, None] * m.double() for m, r in rules)
        same = sum((h[blk] * (W @ h)).sum(0) for h in hot64)
        score += W.sum() - same
    return dict(zip(sel.tolist(), (score / n).cpu().numpy()))


def gwas_gather_phase(dev, n=8192, p=5_000_000, seed=25, sample=1024,
                      tail=1024, chunk_rows=256, ref_chunk=65536):
    """gwas-gather: (n, p) genotypes (column 0 = 2y, balanced labels)
    drawn on the card a chunk of rows at a time straight into
    ``stage_codes_packed``, so the unpacked matrix never exists, then
    scored by ``relief_discrete_scores`` from the packed codes: v2-gather,
    peak memory over the fit under n p / 2 bytes, column 0 first, and
    column 0, ``sample`` sampled features and the last ``tail`` held to
    :func:`gwas_referee`."""
    y = balanced_labels(n, seed)
    gen = torch.Generator(device=dev).manual_seed(seed)
    y_dev = torch.as_tensor(2 * y, dtype=torch.int8, device=dev)

    def chunks():
        for r0 in range(0, n, chunk_rows):
            c = torch.randint(0, 3, (min(chunk_rows, n - r0), p),
                              generator=gen, device=dev, dtype=torch.int8)
            c[:, 0] = y_dev[r0:r0 + c.shape[0]]
            yield c

    t0 = time.perf_counter()
    pk = rd.stage_codes_packed(chunks(), 3, dev, shape=(n, p))
    torch.cuda.synchronize()
    data_s = time.perf_counter() - t0
    tier = rd.discrete_tier(n, p, 3, y, "multisurf", device=dev,
                            source="packed")
    check(tier == "v2-gather", f"gwas-gather: tier {tier}")
    layout, ti, ft = rd._tiles_and_layout(n, p, 3, y, "multisurf", None, dev)
    blocks, windows = layout[4] // ti, -(-pk.p_eff // ft)
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats(dev)
    rd.reset_gemm_ops()
    before = launch_counts()
    with RouteSpy() as spy, PhaseRecords("relief_discrete.gather") as rec:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        s = rd.relief_discrete_scores(None, y, algo="multisurf", codes=pk,
                                      n_states=3)
        torch.cuda.synchronize()
        fit_s = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated(dev)
    ops = rd.gemm_ops
    moved = launches_since(before)
    check(spy.seen == ["gather-2"], f"gwas-gather: routes {spy.seen}")
    check(not any(moved.values()), f"gwas-gather: fused launches {moved}")
    check(s.shape == (p,) and np.isfinite(s).all(),
          f"gwas-gather: finite scores of shape ({p},)")
    check(int(np.argmax(s)) == 0, "gwas-gather: column 0 ranks first")
    check(peak < 0.5 * n * p, f"gwas-gather: peak {peak / 1e9:.2f} GB not "
          f"under n p / 2 = {0.5 * n * p / 1e9:.2f} GB")
    pass_s = {k: sum(sec for name, sec in rec.records
                     if name.endswith(k)) for k in ("pass1", "pass2")}
    rng = np.random.RandomState(seed)
    feats = np.concatenate([[0], rng.choice(np.arange(1, p - tail), sample,
                                            replace=False),
                            np.arange(p - tail, p)])
    t0 = time.perf_counter()
    ref = gwas_referee(dev, pk, y, feats, ti, ref_chunk)
    ref_s = time.perf_counter() - t0
    del pk
    torch.cuda.empty_cache()
    err = close("gwas-gather", s[feats],
                np.asarray([ref[f] for f in feats]))
    rate = ops / fit_s / 1e12
    print(f"gwas-gather: relief_discrete_scores(multisurf) on {n}x{p} "
          f"genotypes packed on the card (drawn and packed in {data_s:.2f} "
          f"s) tier v2-gather; fit {fit_s:.4f} s, gemm_ops {ops:.4e} "
          f"({rate:.1f} TOP/s), {blocks} focal blocks of {ti}, {windows} "
          f"windows of {ft} a pass and block, pass 1 {pass_s['pass1']:.4f} "
          f"s, pass 2 with the rules {pass_s['pass2']:.4f} s; peak "
          f"{peak / 1e9:.2f} GB (n p / 2 = {0.5 * n * p / 1e9:.2f}); column "
          f"0 first; referee ({len(feats)} features, {ref_s:.2f} s) max "
          f"|scores - referee| {err:.3e}", flush=True)
    return dict(first_s=fit_s, gemm_ops=ops, tops=rate, peak_gb=peak / 1e9,
                windows=windows, blocks=blocks, pass1_s=pass_s["pass1"],
                pass2_s=pass_s["pass2"], err=err, data_s=data_s,
                referee_s=ref_s)


def gwas_phase(dev, X, y, head, sizes=None):
    """Phase 24: the pack and window checks, the headline's forced routes,
    gwas-promote and gwas-gather (``sizes``: their keyword arguments, for
    a rehearsal at a small size)."""
    sizes = sizes or {}
    t0 = time.perf_counter()
    compared = pack_checks(dev, **sizes.get("pack", {}))
    print(f"gwas pack checks: {compared} tensors packed, unpacked, matched "
          f"and promoted on the card equal the CPU's", flush=True)
    window0 = launch_counts((*WINDOW_KERNELS, *GEMM_KERNELS))
    res = {"routes": headline_routes(dev, X, y, head)}
    res["gwas-promote"] = gwas_promote_phase(dev, **sizes.get("promote", {}))
    res["gwas-gather"] = gwas_gather_phase(dev, **sizes.get("gather", {}))
    res["window_launches"] = launches_since(window0)
    # the window kernels and the int8 GEMM run on the card; on the CPU
    # their twins do
    check(dev.type != "cuda" or all(res["window_launches"].values()),
          f"gwas: window kernels and the int8 GEMM launched "
          f"{res['window_launches']}")
    res["phase_s"] = time.perf_counter() - t0
    print(f"gwas: phase {res['phase_s']:.2f} s", flush=True)
    return res


# ---------------------------------------------------------------------------
# The multi-device layer on a mesh of shards (several on one card)
# ---------------------------------------------------------------------------

def mesh_name(mesh):
    return "+".join(str(d) for d in mesh)


class MeshRoute:
    """Within the block, the automatic routes take ``mesh``
    (``relief._mesh_devices``; None: the route's own mesh),
    ``_RING_BYTES`` is ``ring_bytes`` when given, and each (module, name)
    in ``spies`` counts its calls in ``calls``."""

    def __init__(self, mesh, spies=(), ring_bytes=None):
        self.mesh, self.spies, self.ring_bytes = mesh, spies, ring_bytes
        self.calls = []

    def __enter__(self):
        self.saved = [(relief_mod, "_mesh_devices", relief_mod._mesh_devices),
                      (relief_mod, "_RING_BYTES", relief_mod._RING_BYTES)]
        if self.mesh is not None:
            relief_mod._mesh_devices = lambda device: list(self.mesh)
        if self.ring_bytes is not None:
            relief_mod._RING_BYTES = self.ring_bytes
        for module, name in self.spies:
            orig = getattr(module, name)
            self.saved.append((module, name, orig))

            def spy(*a, _name=name, _orig=orig, **k):
                self.calls.append(_name)
                return _orig(*a, **k)
            setattr(module, name, spy)
        return self

    def __exit__(self, *exc):
        for module, name, value in reversed(self.saved):
            setattr(module, name, value)


def mesh_timed(mesh, fn):
    """(fn(), seconds, peak GB over the mesh's devices) with every device
    synchronised at both ends and its peak statistics reset before."""
    devs = psh.distinct(parallel.make_mesh(mesh))
    for d in devs:
        torch.cuda.reset_peak_memory_stats(d)
        torch.cuda.synchronize(d)
    t0 = time.perf_counter()
    out = fn()
    for d in devs:
        torch.cuda.synchronize(d)
    sec = time.perf_counter() - t0
    return out, sec, max(torch.cuda.max_memory_allocated(d)
                         for d in devs) / 1e9


def mesh_fit_phase(mesh, label, make, X, y, single, route, kind, tol,
                   warm=1, ring_bytes=None):
    """``make().fit(X, y)`` through the automatic route with ``mesh``
    (then ``warm`` more, timed): it must call ``route`` (module, name) and
    run the ``kind`` of work ('cont' or 'mixed' kernels, or 'gemm': int8
    GEMMs and no Relief kernel; on the card the int8 GEMM kernel),
    launches counted over the first fit; its scores agree with
    ``single`` (the fit on one device) within ``tol`` (atol, rtol), its
    top_features_ alike.
    The first mesh's scores are kept in ``MESH_RESULTS[label]``, the first
    mesh's launches of the int8 GEMM in ``MESH_GEMM_LAUNCHES[label]``; a
    ring fit's sweeps and rules are timed apart (``ring_phases``).
    Returns (first fit's seconds, warm fits' seconds, peak GB)."""
    with MeshRoute(mesh, [route], ring_bytes) as mr, \
            PhaseRecords("ring.", on=ring_bytes is not None) as ring_log:
        before = launch_counts()
        gemm0 = launch_counts(GEMM_KERNELS)
        rd.reset_gemm_ops()
        est, sec, peak = mesh_timed(mesh, lambda: make().fit(X, y))
        launches, ops = launches_since(before), rd.gemm_ops
        gemm = launches_since(gemm0)
        warm_s = [mesh_timed(mesh, lambda: make().fit(X, y))[1]
                  for _ in range(warm)]
    s = est.feature_importances_
    MESH_RESULTS.setdefault(label, s)
    err = float(np.abs(s - single).max())
    top = np.argsort(single)[::-1][:len(est.top_features_)]
    check(mr.calls == [route[1]] * (1 + warm),
          f"{label}: routed to {mr.calls}, expected {route[1]}")
    if kind == "gemm":
        check(ops > 0 and not any(launches.values()),
              f"{label}: int8 GEMMs ({ops} ops) and no Relief kernel "
              f"({launches})")
        check(mesh[0].type != "cuda" or all(gemm.values()),
              f"{label}: the int8 GEMM launched {gemm} on {mesh_name(mesh)}")
        MESH_GEMM_LAUNCHES.setdefault(label, gemm)
    else:
        other = "mixed" if kind == "cont" else "cont"
        check(launches[f"relief_pass1_{kind}"] > 0
              and launches[f"relief_pass2_{kind}"] > 0
              and launches[f"relief_pass1_{other}"] == 0
              and launches[f"relief_pass2_{other}"] == 0,
              f"{label}: launched the {kind} kernels {launches}")
    check(s.shape == single.shape and np.isfinite(s).all(),
          f"{label}: finite scores")
    check(np.allclose(s, single, atol=tol[0], rtol=tol[1]),
          f"{label}: max |scores - one device| {err} over atol {tol[0]} "
          f"rtol {tol[1]}")
    check(np.array_equal(est.top_features_, top),
          f"{label}: top_features_ {est.top_features_} vs {top}")
    print(f"{label}: {type(est).__name__} X {X.shape[0]}x{X.shape[1]} on "
          f"{len(mesh)} shards ({mesh_name(mesh)}) via {route[1]}; fit "
          f"{sec:.4f} s{''.join(f', warm {t:.4f} s' for t in warm_s)}; peak "
          f"{peak:.2f} GB; launches {launches}"
          f"{f', {gemm}' if kind == 'gemm' else ''}; gemm_ops {ops:.4e}; max "
          f"|scores - one device| {err:.3e}; top_features_ equal",
          flush=True)
    if ring_log.records:
        print(f"{label}: ring phases (synchronised at their edges) "
              f"{ring_log.summary()} on {SMI}", flush=True)
    return sec, warm_s, peak


def mesh_mixed_phase(dev, mesh, X, y, single_est, discrete_limit=200):
    """``sharded_relief_scores`` called directly on mixed data (with its
    150-state column: the MIXED kernels on every shard) against the
    one-device fit of the same estimator settings."""
    label = "mesh-mixed"
    y_enc = np.unique(y, return_inverse=True)[1]
    x_dev = torch.tensor(X, dtype=torch.float32, device=dev)
    fa = analyze_features(x_dev, discrete_limit)
    before = launch_counts()
    s, sec, peak = mesh_timed(mesh, lambda: parallel.sharded_relief_scores(
        x_dev, y_enc, fa.recip, fa.is_discrete, algo="multisurf",
        devices=mesh))
    launches = launches_since(before)
    MESH_RESULTS.setdefault(label, s)
    single = single_est.feature_importances_
    err = float(np.abs(s - single).max())
    top = np.argsort(s)[::-1][:len(single_est.top_features_)]
    check(launches["relief_pass1_mixed"] > 0
          and launches["relief_pass2_mixed"] > 0,
          f"{label}: launched the MIXED kernels {launches}")
    check(err <= fit_tol(single), f"{label}: max |scores - one device| "
          f"{err}")
    check(np.array_equal(top, single_est.top_features_),
          f"{label}: top features {top} vs {single_est.top_features_}")
    print(f"{label}: sharded_relief_scores X {X.shape[0]}x{X.shape[1]} "
          f"({int(fa.is_discrete.sum())} discrete, {fa.n_states} states) on "
          f"{len(mesh)} shards ({mesh_name(mesh)}): {sec:.4f} s; peak "
          f"{peak:.2f} GB; launches {launches}; max |scores - one device| "
          f"{err:.3e}; top features equal", flush=True)
    return sec


def mesh_mdr_phase(dev, mesh, X, y, planted, single):
    """MDR(k=3, cv=5) through ShardedMDRFoldScorer (the fit's route with
    the mesh), then that scorer's search alone: every fold's best rank and
    key equal to the one-device search's (``single``: phase 19's result)."""
    label = "mesh-mdr"
    k = 3
    before = launch_counts()
    with MeshRoute(mesh, [(mdr_mod, "ShardedMDRFoldScorer")]) as mr:
        rd.reset_gemm_ops()
        est, fit_s, peak = mesh_timed(mesh, lambda: MDR(k=k, cv=5).fit(X, y))
        ops = rd.gemm_ops
    check(mr.calls == ["ShardedMDRFoldScorer"],
          f"{label}: the fit made {mr.calls}")
    check(launch_counts() == before and ops > 0,
          f"{label}: int8 GEMMs ({ops} ops) and no Relief kernel")
    check(est.best_interaction_ == planted and est.best_cvc_ == 5,
          f"{label}: best {est.best_interaction_} CVC {est.best_cvc_}")
    check(est._fold_best == single["est"]._fold_best,
          f"{label}: fold winners {est._fold_best}")
    _, w_case, w_ctrl = mdr_folds(est, X, y)
    p = X.shape[1]
    scorer = parallel.ShardedMDRFoldScorer(X, w_case, w_ctrl, k,
                                           devices=mesh)
    (_, keys, ranks), search_s, _ = mesh_timed(mesh, lambda: scorer.search(
        p, math.comb(p, k), chunk=mdr_mod._COMBO_CHUNK))
    check(np.array_equal(ranks, single["ranks"])
          and np.array_equal(keys, single["keys"]),
          f"{label}: ranks {ranks} keys {keys} vs one device's "
          f"{single['ranks']} {single['keys']}")
    MESH_RESULTS.setdefault(label, (est._fold_best, ranks, keys))
    del scorer
    print(f"{label}: MDR(k=3, cv=5) X {X.shape[0]}x{p} on {len(mesh)} "
          f"shards ({mesh_name(mesh)}) via ShardedMDRFoldScorer: fit "
          f"{fit_s:.4f} s, search alone {search_s:.4f} s; gemm_ops "
          f"{ops:.4e}; peak {peak:.3f} GB; best {est.best_interaction_} "
          f"CVC 5/5; every fold's rank and key == one device's "
          f"({ranks.tolist()})", flush=True)
    return fit_s


def stats_codes(n=2000, p=5000):
    """mrmr's codes 0..4 (encoded with y) of the mesh-stats phases."""
    rng = np.random.RandomState(14)
    X = rng.randint(0, 5, (n, p))
    y = rng.randint(0, 2, n)
    return mrmr_mod._encode_union(X, y)[0]


def digest(a) -> str:
    """SHA-256 of an array's dtype, shape and bytes: equal digests, equal
    bits."""
    a = np.ascontiguousarray(a)
    return hashlib.sha256(f"{a.dtype}{a.shape}".encode()
                          + a.tobytes()).hexdigest()


def mesh_stats_phase(dev, mesh, n=2000, p=5000):
    """The MI matrix of mrmr's codes with its pair tiles sharded, equal bit
    for bit to the one-device matrix, and through pairwise_stat_matrix's
    route (symmetrised) equal to its one-device path."""
    label = "mesh-stats"
    X_enc = stats_codes(n, p)
    rd.reset_gemm_ops()
    got, sec, peak = mesh_timed(mesh, lambda: feature_shard
                                .sharded_pairwise_stat_matrix(
                                    X_enc, 5, "mi", devices=mesh))
    ops = rd.gemm_ops
    want, single_s, _ = mesh_timed([dev], lambda: ct.pairwise_stat_matrix(
        X_enc, 5, "mi", device=dev, symmetric=False))
    check(ops > 0 and np.array_equal(got, want),
          f"{label}: sharded MI matrix == one device's, bit for bit")
    MESH_RESULTS.setdefault(label, digest(got))
    with MeshRoute(mesh, [(feature_shard, "sharded_pairwise_stat_matrix")]
                   ) as mr:
        sym = ct.pairwise_stat_matrix(X_enc, 5, "mi", device=dev)
    check(mr.calls == ["sharded_pairwise_stat_matrix"]
          and np.array_equal(sym, ct.pairwise_stat_matrix(
              X_enc, 5, "mi", device=dev)),
          f"{label}: pairwise_stat_matrix's route == its one-device path")
    print(f"{label}: sharded_pairwise_stat_matrix 'mi' on {n}x{p} codes, "
          f"{len(mesh)} shards ({mesh_name(mesh)}): {sec:.4f} s (one "
          f"device {single_s:.4f} s), gemm_ops {ops:.4e}, peak {peak:.2f} "
          f"GB; equal bit for bit, and pairwise_stat_matrix's route too",
          flush=True)
    return sec


def profiling_phase(dev, X, y, logdir):
    """utils.profiling.timed_fit on X, one fit with its phases logged at
    INFO, and one fit traced by utils.profiling.trace into ``logdir``."""
    timing = profiling.timed_fit(lambda: MultiSURF(n_features_to_select=10),
                                 X, y)
    check(timing.seconds > 0 and timing.peak_rss_mb > 0,
          "profiling: timed_fit measured the fit")
    print(f"profiling: timed_fit MultiSURF X {X.shape[0]}x{X.shape[1]}: "
          f"{timing}", flush=True)
    records = []
    handler = logging.Handler()
    handler.emit = records.append
    logger = logging.getLogger("fastselect_tpu_torch")
    level = logger.level
    logger.setLevel(logging.INFO)
    logger.addHandler(handler)
    try:
        MultiSURF(n_features_to_select=10).fit(X, y)
    finally:
        logger.removeHandler(handler)
        logger.setLevel(level)
    msgs = [r.getMessage() for r in records]
    check(any(m.startswith("relief_cuda.engine[multisurf]") for m in msgs),
          f"profiling: phase records {msgs}")
    print(f"profiling: phase records at INFO: {msgs}", flush=True)
    with profiling.trace(str(logdir)) as prof:
        t0 = time.perf_counter()
        MultiSURF(n_features_to_select=10).fit(X, y)
        wall = time.perf_counter() - t0
    path = Path(logdir) / "trace.json"
    check(path.is_file() and path.stat().st_size > 0,
          f"profiling: trace written to {path}")
    # kernel rows only: an aten op's self device time repeats its kernels'
    busy = sum(getattr(e, "self_device_time_total", 0)
               for e in prof.key_averages()
               if getattr(e, "device_type", None)
               == torch.autograd.DeviceType.CUDA) / 1e6
    print(f"profiling: trace of one fit -> {path} "
          f"({path.stat().st_size} bytes); kernels' device time {busy:.4f} "
          f"s of the fit's {wall:.4f} s under the profiler", flush=True)
    return timing


# ---------------------------------------------------------------------------
# The mesh across processes: four processes sharing the first card
# ---------------------------------------------------------------------------

def _member(rank, fn, args, world, store_path, out_dir, timeout_s):
    """One process of :func:`run_processes`: join the gloo group, run
    ``fn``, write its result."""
    import torch.distributed as dist
    dist.init_process_group(
        "gloo", store=dist.FileStore(store_path, world), rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=timeout_s))
    try:
        out = fn(*args)
        with open(Path(out_dir) / f"{rank}.pkl", "wb") as f:
            pickle.dump(out, f)
    finally:
        dist.destroy_process_group()


def run_processes(fn, world: int, args=(), *, deadline_s: float = 120.0):
    """``fn(*args)`` in ``world`` new processes (the ``spawn`` start
    method) joined in a gloo group through a ``FileStore`` in a temporary
    directory; each rank's return value, in rank order.

    ``fn`` must be importable by the children (a module's top-level
    function).  A process that raises makes this raise (the others are
    ended); processes still running after ``deadline_s`` seconds, as a
    deadlocked collective leaves them, are terminated and a
    ``TimeoutError`` is raised."""
    import torch.multiprocessing as mp
    with tempfile.TemporaryDirectory(prefix="fs_group_") as tmp:
        ctx = mp.spawn(_member, nprocs=world, join=False, args=(
            fn, args, world, str(Path(tmp) / "store"), tmp,
            int(deadline_s) + 60))
        stop = time.monotonic() + deadline_s
        try:
            while not ctx.join(timeout=max(stop - time.monotonic(), 0.1)):
                if time.monotonic() >= stop:
                    raise TimeoutError(
                        f"{world} processes still running after "
                        f"{deadline_s} s: terminated")
        finally:
            for proc in ctx.processes:
                if proc.is_alive():
                    proc.terminate()
            for proc in ctx.processes:
                proc.join(5)
                if proc.is_alive():
                    proc.kill()
                    proc.join()
        out = []
        for rank in range(world):
            with open(Path(tmp) / f"{rank}.pkl", "rb") as f:
                out.append(pickle.load(f))
        return out


# phase 23's layouts: (label, phase 21's label, route (module, name), kind
# of work, held to phase 21 bit for bit: all but large-n, whose focal
# blocks follow the budget shared on the card)
PROCS_LAYOUTS = (
    ("mesh-procs-large-n", "mesh-large-n", (psh, "sharded_relief_scores"),
     "cont", False),
    ("mesh-procs-mixed", "mesh-mixed", (psh, "sharded_relief_scores"),
     "mixed", True),
    ("mesh-procs-snp", "mesh-snp",
     (feature_shard, "feature_sharded_relief_discrete_scores"), "gemm",
     True),
    ("mesh-procs-v2", "mesh-v2", (psh, "_sharded_discrete_v2"), "gemm",
     True),
    ("mesh-procs-ring", "mesh-ring", (parallel.ring, "_ring_skip_table"),
     "gemm", True),
    ("mesh-procs-mdr", "mesh-mdr", (mdr_mod, "ShardedMDRFoldScorer"), "gemm",
     True),
    ("mesh-procs-stats", "mesh-stats",
     (feature_shard, "sharded_pairwise_stat_matrix"), "gemm", True))


def procs_timed(dev, fn):
    """(fn(), seconds, peak GB) in one process of the group: the group
    starts together (a barrier), this process's card is synchronised at
    both ends and its peak statistics reset before."""
    if dev.type == "cuda":
        torch.cuda.reset_peak_memory_stats(dev)
        torch.cuda.synchronize(dev)
    torch.distributed.barrier()
    t0 = time.perf_counter()
    out = fn()
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
    sec = time.perf_counter() - t0
    peak = (torch.cuda.max_memory_allocated(dev) / 1e9 if dev.type == "cuda"
            else 0.0)
    return out, sec, peak


def procs_run(dev, fn, route, keep, warm=0, ring_bytes=None):
    """One layout in a process of the group: ``fn()`` through ``route``
    (module, name) on the group's own mesh, then ``warm`` more; the
    launches counted over the first, and ``gemm_ops`` and the
    collectives' counts set to 0 before it and read after it."""
    with MeshRoute(None, [route], ring_bytes) as mr, \
            PhaseRecords("ring.", on=ring_bytes is not None) as ring_log:
        before = launch_counts()
        rd.reset_gemm_ops()
        psh.reset_comm()
        out, sec, peak = procs_timed(dev, fn)
        launches, ops, comm = (launches_since(before), rd.gemm_ops,
                               dict(psh.comm))
        ring = list(ring_log.records)
        warm_s = [procs_timed(dev, fn)[1] for _ in range(warm)]
    return {"result": keep(out), "first_s": sec, "warm_s": warm_s,
            "peak_gb": peak, "launches": launches, "gemm_ops": ops,
            "comm": comm, "calls": list(mr.calls), "ring": ring}


def mesh_procs_worker(paths, device, stats_shape, setup=None):
    """One of phase 23's processes (a gloo group): every layout on the
    group's mesh, one shard a process, with the focal-block budget shared
    among the processes on the card; each layout's result, times, peak
    memory, launches, ``gemm_ops`` and collective bytes and seconds.
    ``setup`` (a test's) runs first."""
    if setup is not None:
        setup()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device(device)
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    data = {name: np.load(path) for name, path in paths.items()}
    mesh = parallel.make_mesh()
    scores = lambda est: est.feature_importances_  # noqa: E731
    make = lambda: MultiSURF(n_features_to_select=10)  # noqa: E731
    make_v2 = lambda: MultiSURF(n_features_to_select=3,  # noqa: E731
                                use_star=True)
    runs = {}
    runs["mesh-procs-large-n"] = procs_run(
        dev, lambda: make().fit(data["X_n"], data["y_n"]),
        PROCS_LAYOUTS[0][2], scores, warm=1)
    x_dev = torch.tensor(data["X_mf"], dtype=torch.float32, device=dev)
    fa = analyze_features(x_dev, 200)
    y_enc = np.unique(data["y_mf"], return_inverse=True)[1]
    runs["mesh-procs-mixed"] = procs_run(
        dev, lambda: psh.sharded_relief_scores(
            x_dev, y_enc, fa.recip, fa.is_discrete, algo="multisurf",
            devices=mesh), PROCS_LAYOUTS[1][2], lambda s: s, warm=1)
    runs["mesh-procs-snp"] = procs_run(
        dev, lambda: make().fit(data["X_snp"], data["y_snp"]),
        PROCS_LAYOUTS[2][2], scores)
    del data["X_snp"]
    X, y = data["X_v2"], data["y_v2"]
    runs["mesh-procs-v2"] = procs_run(dev, lambda: make_v2().fit(X, y),
                                      PROCS_LAYOUTS[3][2], scores)
    runs["mesh-procs-ring"] = procs_run(dev, lambda: make_v2().fit(X, y),
                                        PROCS_LAYOUTS[4][2], scores,
                                        ring_bytes=X.size - 1)
    X, y, k = data["X_k3"], data["y_k3"], 3
    mdr = procs_run(dev, lambda: MDR(k=k, cv=5).fit(X, y),
                    PROCS_LAYOUTS[5][2], lambda est: est)
    est = mdr["result"]
    _, w_case, w_ctrl = mdr_folds(est, X, y)
    p = X.shape[1]
    scorer = parallel.ShardedMDRFoldScorer(X, w_case, w_ctrl, k,
                                           devices=mesh)
    (_, keys, ranks), search_s, _ = procs_timed(dev, lambda: scorer.search(
        p, math.comb(p, k), chunk=mdr_mod._COMBO_CHUNK))
    mdr.update(result=(est._fold_best, ranks, keys), search_s=search_s,
               best=(est.best_interaction_, est.best_cvc_))
    runs["mesh-procs-mdr"] = mdr
    X_enc = stats_codes(*stats_shape)
    runs["mesh-procs-stats"] = procs_run(
        dev, lambda: feature_shard.sharded_pairwise_stat_matrix(
            X_enc, 5, "mi", devices=mesh), PROCS_LAYOUTS[6][2], digest)
    return {"rank": torch.distributed.get_rank(),
            "mesh": [str(d) for d in mesh],
            "sharers": psh.sharers(mesh, dev), "runs": runs,
            "imports": [m for m in ("jax", "fastselect_tpu")
                        if m in sys.modules]}


def same(a, b) -> bool:
    """a and b equal bit for bit (arrays, digests, or tuples of them)."""
    if isinstance(a, (tuple, list)):
        return len(a) == len(b) and all(same(u, v) for u, v in zip(a, b))
    if isinstance(a, np.ndarray):
        return a.dtype == b.dtype and np.array_equal(a, b)
    return a == b


def collectives_check(dev, backend):
    """The collective helpers in a one-rank ``backend`` group on ``dev``
    (NCCL on the card): float psum, integer psum, tiled all_gather of
    uneven parts and merge_disjoint equal to the one-process mesh's bits.
    Returns (calls, bytes, seconds) of the group's collectives."""
    import torch.distributed as dist
    if dev.type == "cuda":
        torch.cuda.set_device(dev)
    with tempfile.TemporaryDirectory(prefix="fs_one_rank_") as tmp:
        dist.init_process_group(backend, store=dist.FileStore(
            str(Path(tmp) / "store"), 1), rank=0, world_size=1)
        try:
            group = parallel.make_mesh([(0, dev)] * 4)
            one = parallel.make_mesh([dev] * 4)
            gen = torch.Generator(device=dev).manual_seed(23)
            parts = [torch.randn(1 << 16, device=dev, generator=gen)
                     * 10.0 ** s for s in range(4)]
            ints = [torch.randint(-1000, 1000, (1 << 16,), device=dev,
                                  generator=gen, dtype=torch.int32)
                    for _ in range(4)]
            uneven = [p[:n] for p, n in zip(parts, (5, 0, 17, 3))]
            psh.reset_comm()
            check(torch.equal(psh.psum(parts, group),
                              psh.psum(parts, one)),
                  f"{backend}: float psum == the one-process mesh's bits")
            check(torch.equal(psh.psum(ints, group), psh.psum(ints, one)),
                  f"{backend}: integer psum (all_reduce) exact")
            check(torch.equal(psh.all_gather(uneven, group),
                              psh.all_gather(uneven, one)),
                  f"{backend}: all_gather of uneven parts")
            check(torch.equal(psh.merge_disjoint(parts[3], group),
                              parts[3]),
                  f"{backend}: merge_disjoint keeps the bits")
            check(group.group is not None and psh.comm["calls"] == 5,
                  f"{backend}: the helpers called the collectives "
                  f"({psh.comm})")
            return dict(psh.comm)
        finally:
            dist.destroy_process_group()


def mesh_procs_phase(dev, data, stats_shape=(2000, 5000), setup=None):
    """23. mesh-procs: ``MESH_PROCS`` processes sharing ``dev`` in a gloo
    group (:func:`run_processes`: spawn, a FileStore, a hard
    deadline), each running every layout of ``PROCS_LAYOUTS`` on the
    group's mesh; every rank's result equal to every other's bit for bit
    and held to phase 21's on the same four shards (``MESH_RESULTS``),
    bit for bit where ``PROCS_LAYOUTS`` says so, else within phase 21's
    tolerance; then the collectives on ``dev`` in a one-rank group
    (NCCL on the card).  Returns each kernel's launches summed over the
    processes' first fits."""
    t0 = time.perf_counter()
    root = Path(__file__).resolve().parent / "build" / "mesh-procs"
    root.mkdir(parents=True, exist_ok=True)
    paths = {}
    for name, a in data.items():
        paths[name] = str(root / f"{name}.npy")
        np.save(paths[name], a)
    if dev.type == "cuda":
        torch.cuda.empty_cache()
    staged_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    try:
        reports = run_processes(
            mesh_procs_worker, MESH_PROCS,
            (paths, str(dev), stats_shape, setup),
            deadline_s=MESH_PROCS_DEADLINE_S)
    finally:
        shutil.rmtree(root, ignore_errors=True)
    group_s = time.perf_counter() - t0
    check([r["rank"] for r in reports] == list(range(MESH_PROCS)),
          "mesh-procs: every rank reported")
    for r in reports:
        check(r["mesh"] == [str(dev)] * MESH_PROCS
              and r["sharers"] == MESH_PROCS and r["imports"] == [],
              f"mesh-procs rank {r['rank']}: mesh {r['mesh']}, "
              f"{r['sharers']} processes on the card, imports "
              f"{r['imports']}")
    launches = {name: 0 for name in KERNELS}
    for label, ref_label, route, kind, exact in PROCS_LAYOUTS:
        runs = [r["runs"][label] for r in reports]
        first = runs[0]["result"]
        want = MESH_RESULTS[ref_label]
        for rank, run in enumerate(runs):
            check(run["calls"] == [route[1]] * (1 + len(run["warm_s"])),
                  f"{label} rank {rank}: routed to {run['calls']}")
            got = run["launches"]
            if kind == "gemm":
                check(not any(got.values()),
                      f"{label} rank {rank}: no Relief kernel ({got})")
            else:
                other = "mixed" if kind == "cont" else "cont"
                check(got[f"relief_pass1_{kind}"] > 0
                      and got[f"relief_pass2_{kind}"] > 0
                      and got[f"relief_pass1_{other}"] == 0
                      and got[f"relief_pass2_{other}"] == 0,
                      f"{label} rank {rank}: launched the {kind} kernels "
                      f"{got}")
            for name in launches:
                launches[name] += got[name]
            check(run["comm"]["calls"] > 0 and run["comm"]["bytes"] > 0,
                  f"{label} rank {rank}: collectives {run['comm']}")
            check(same(run["result"], first),
                  f"{label}: rank {rank}'s result == rank 0's, bit for bit")
        if kind == "gemm":
            check(sum(r["gemm_ops"] for r in runs) > 0,
                  f"{label}: int8 GEMMs on the processes")
        if exact:
            check(same(first, want),
                  f"{label}: == {ref_label}'s (one process), bit for bit")
            err = "0 (bit for bit)"
        else:
            err = float(np.abs(first - want).max())
            check(np.isfinite(first).all() and err <= fit_tol(want),
                  f"{label}: max |scores - {ref_label}| {err}")
            err = f"{err:.3e}"
        warm = [max(run["warm_s"][i] for run in runs)
                for i in range(len(runs[0]["warm_s"]))]
        extra = ""
        if label == "mesh-procs-mdr":
            extra = (f", search alone {max(r['search_s'] for r in runs):.4f}"
                     f" s, best {runs[0]['best']}")
        if runs[0]["ring"]:
            extra = "; ring phases (slowest rank) " + ", ".join(
                f"{name} {max(r['ring'][i][1] for r in runs):.4f} s"
                for i, (name, _) in enumerate(runs[0]["ring"]))
        print(f"{label}: {MESH_PROCS} processes x 1 shard on {dev} via "
              f"{route[1]}; first fit {max(r['first_s'] for r in runs):.4f}"
              f" s (slowest rank){''.join(f', warm {t:.4f} s' for t in warm)}"
              f"; peak GB a process "
              f"{[round(r['peak_gb'], 3) for r in runs]}; collectives a "
              f"process {runs[0]['comm']['calls']} calls, "
              f"{runs[0]['comm']['bytes'] / 1e6:.3f} MB, "
              f"{max(r['comm']['seconds'] for r in runs):.4f} s (slowest "
              f"rank); launches {[sum(r['launches'].values()) for r in runs]}"
              f", gemm_ops {[r['gemm_ops'] for r in runs]}{extra}; "
              f"every rank equal; max |result - {ref_label}| {err} on "
              f"{SMI}", flush=True)
    for name in KERNELS:
        check(launches[name] > 0,
              f"{name} launched by phase 23's processes")
    backend = "nccl" if dev.type == "cuda" else "gloo"
    comm = collectives_check(dev, backend)
    print(f"mesh-procs: data staged in {staged_s:.2f} s; group of "
          f"{MESH_PROCS} processes (spawn, start included) {group_s:.2f} s;"
          f" launches over the processes {launches}; a one-rank {backend} "
          f"group on {dev}: psum, all_gather, merge_disjoint equal to the "
          f"one-process mesh ({comm['calls']} collectives, "
          f"{comm['bytes'] / 1e6:.3f} MB, {comm['seconds']:.4f} s) on "
          f"{SMI}", flush=True)
    return launches


# ---------------------------------------------------------------------------
# Phase 25: the staging layer (pinned, pipelined host-to-device copies)
# ---------------------------------------------------------------------------

def synced_s(fn):
    """(fn(), seconds) with the card synchronised at both ends."""
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def host_rounded(X32, td):
    """float32 X rounded on the host by the stager's cast to ``td``: numpy
    for float16, torch (through float32, as ml_dtypes) for bfloat16."""
    if td == "float16":
        return X32.astype(np.float16).astype(np.float32)
    return torch.from_numpy(X32).to(torch.bfloat16).float().numpy()


def staging_fits(dev, X, y, td, warm=2):
    """``MultiSURF(transfer_dtype=td).fit``, first and ``warm`` more, then
    one more with the ``staging.`` phase records: (estimator, seconds,
    peak GB of each, records).  Each fit must launch the continuous
    kernels."""
    make = lambda: MultiSURF(n_features_to_select=10,  # noqa: E731
                             transfer_dtype=td)
    times, peaks = [], []
    for _ in range(1 + warm):
        before = launch_counts()
        est, sec, peak = timed_fit(dev, make(), X, y)
        for name in ("relief_pass1_cont", "relief_pass2_cont"):
            check(_build.launches[name] > before[name],
                  f"staging {td}: the fit launched {name}")
        times.append(sec)
        peaks.append(peak)
    with PhaseRecords("staging.") as rec:
        timed_fit(dev, make(), X, y)
    return est, times, peaks, rec


def staging_phase(dev, X_p, y_p, X_snp, gwas, shape=(100, 500000)):
    """Phase 25: the staging layer.  ``MultiSURF().fit`` on the reference's
    p >> n point, 100 x 500,000 float64 host X, at every
    ``transfer_dtype``: the float32 fit equal to today's one-shot copy
    (the stager's gate raised) bit for bit, each half-width fit equal to a
    float32 fit of X rounded on the host by the same cast; then the
    stager's chunk widths timed on that X and on phase 7's codes (against
    one pageable copy), and the copy seconds of phases 5, 7 and 24."""
    t0 = time.perf_counter()
    X, y = make_classification(n_samples=shape[0], n_features=shape[1],
                               random_state=25)
    X32 = X.astype(np.float32)
    n, p = X.shape
    data_s = time.perf_counter() - t0
    ref, one_s, one_peak = with_threshold(
        _relief_base, "_STAGED_MIN_ELEMS", 1 << 62,
        lambda: timed_fit(dev, MultiSURF(n_features_to_select=10), X, y))
    check(not hasattr(ref, "transfer_dtype_"),
          "staging: the one-shot fit set transfer_dtype_")
    out = {"one_shot_s": one_s, "one_shot_peak_gb": one_peak, "fits": {}}
    rounded = {}
    auto = ("float16" if _relief_base._AUTO_HALF_WIDTH
            and X.size >= _relief_base._AUTO_F16_MIN_ELEMS and p >= 4 * n
            else "float32")
    for td in (None, "float32", "float16", "bfloat16"):
        est, times, peaks, rec = staging_fits(dev, X, y, td)
        used = est.transfer_dtype_
        check(used == (td or auto), f"staging {td}: transfer_dtype_ {used}")
        s = est.feature_importances_
        check(s.shape == (p,) and np.isfinite(s).all(),
              f"staging {td}: finite scores of shape ({p},)")
        if used == "float32":
            want, held = ref, "the one-shot fit"
        else:
            if used not in rounded:
                rounded[used] = MultiSURF(
                    n_features_to_select=10, transfer_dtype="float32").fit(
                        host_rounded(X32, used), y)
            want, held = rounded[used], f"a float32 fit of X rounded to {used}"
        check(np.array_equal(s, want.feature_importances_)
              and np.array_equal(est.top_features_, want.top_features_),
              f"staging {td}: scores equal to {held} bit for bit")
        out["fits"][str(td)] = dict(
            used=used, first_s=times[0], warm_s=times[1:],
            peak_gb=max(peaks), records=rec.records)
        print(f"staging {td}: MultiSURF X {n}x{p} float64 staged as "
              f"{used}; fit {times[0]:.4f} s, warm "
              f"{', '.join(f'{t:.4f}' for t in times[1:])} s; peak "
              f"{max(peaks):.2f} GB; {rec.summary()}; scores equal to "
              f"{held} bit for bit (one-shot fit {one_s:.4f} s, peak "
              f"{one_peak:.2f} GB)", flush=True)

    # chunk widths: the staged analysis of X (float32 and float16) and the
    # upload of phase 7's int8 codes, each the best of three
    sweep = {}
    for cb in CHUNK_SWEEP:
        def runs():
            row = {}
            for td in ("float32", "float16"):
                row[f"analysis-{td}"] = min(synced_s(
                    lambda: analyze_features_staged(
                        X32, 10, transfer_dtype=td, device=dev))[1]
                    for _ in range(3))
            row["codes"] = min(synced_s(
                lambda: staging.upload(X_snp, dev, torch.int8))[1]
                for _ in range(3))
            return row
        sweep[f"{cb / (1 << 20):g}"] = with_threshold(
            staging, "_CHUNK_BYTES", cb, runs)
        torch.cuda.empty_cache()
    pageable = min(synced_s(lambda: torch.from_numpy(X_snp).to(dev))[1]
                   for _ in range(3))
    torch.cuda.empty_cache()
    print("staging chunk widths (MB: analysis float32, float16, codes s): "
          + "; ".join(f"{mb}: {r['analysis-float32']:.4f}, "
                      f"{r['analysis-float16']:.4f}, {r['codes']:.4f}"
                      for mb, r in sweep.items())
          + f"; phase 7's codes ({X_snp.nbytes / 1e9:.2f} GB) in one "
          f"pageable copy {pageable:.4f} s", flush=True)
    out.update(sweep=sweep, codes_pageable_s=pageable)

    # the copy seconds of phases 5, 7 and 24 at the stager's own width
    with PhaseRecords("staging.") as rec_p:
        _, fit_p, _ = timed_fit(dev, MultiSURF(n_features_to_select=10),
                                X_p, y_p)
    with PhaseRecords("staging.") as rec_c:
        _, up_s = synced_s(lambda: staging.upload(X_snp, dev, torch.int8))
    promote = dict(gwas["gwas-promote"]["phases"])
    out.update(large_p=dict(fit_s=fit_p, records=rec_p.records),
               codes=dict(upload_s=up_s, records=rec_c.records),
               gwas_promote_h2d_s=promote.get("relief_discrete.h2d"))
    print(f"staging copies: large-p (phase 5) fit {fit_p:.4f} s "
          f"({rec_p.summary()}; one pageable copy before the stager: warm "
          f"fits 19.8-26.5 ms, PERF.md); phase 7's codes staged "
          f"{up_s:.4f} s ({rec_c.summary()}; one pageable copy here "
          f"{pageable:.4f} s); gwas-promote's packed staging "
          f"{promote.get('relief_discrete.h2d')} s (from pageable memory "
          f"before the stager: 2.54-2.83 s, PERF.md); data drawn in "
          f"{data_s:.2f} s; phase 25 {time.perf_counter() - t0:.2f} s on "
          f"{SMI}", flush=True)
    out["phase_s"] = time.perf_counter() - t0
    return out


# ---------------------------------------------------------------------------
# Completeness: ReliefF's weight rule, the drop-in surface, the example
# ---------------------------------------------------------------------------

def trace_device_s(path, name):
    """(device seconds of the kernels, copies and fills launched inside
    the ``name`` ranges, device seconds of all of them) in the Chrome
    trace at ``path``: a device event belongs to a range when the runtime
    call that launched it (same correlation id) starts inside one."""
    events = json.loads(Path(path).read_text())["traceEvents"]
    ranges = [(e["ts"], e["ts"] + e["dur"]) for e in events
              if e.get("name") == name and e.get("cat") == "user_annotation"]
    launched = {e["args"]["correlation"]: e["ts"] for e in events
                if e.get("cat") in ("cuda_runtime", "cuda_driver")
                and "correlation" in e.get("args", {})}
    inside = total = 0.0
    for e in events:
        if e.get("cat") not in ("kernel", "gpu_memcpy", "gpu_memset"):
            continue
        total += e["dur"]
        t = launched.get(e.get("args", {}).get("correlation"))
        if t is not None and any(a <= t <= b for a, b in ranges):
            inside += e["dur"]
    return inside / 1e6, total / 1e6


def rules_device_s(make, X, y, logdir):
    """One fit of ``make()`` under ``utils.profiling.trace`` with ReliefF's
    weight rule in a ``record_function`` range (``relieff_weights`` on the
    fused engine, ``_rules_relieff`` on the others): (device seconds of
    what the rule launched, device seconds of all the fit launched), from
    the trace (zeros on the CPU)."""
    names = [name for name in ("relieff_weights", "_rules_relieff")
             if hasattr(relief_mod, name)]   # an older tree has one rule
    orig = {name: getattr(relief_mod, name) for name in names}

    def ranged(fn):
        def call(*a, **k):
            with torch.profiler.record_function(RULES_RANGE):
                return fn(*a, **k)
        return call

    for name in names:
        setattr(relief_mod, name, ranged(orig[name]))
    try:
        with profiling.trace(str(logdir)):
            make().fit(X, y)
    finally:
        for name in names:
            setattr(relief_mod, name, orig[name])
    return trace_device_s(Path(logdir) / "trace.json", RULES_RANGE)


def relieff_rule_fits(dev, label, make, X, y, must_launch=(), tier=None,
                      ref=None, warm=2):
    """Phase 26 (a): ``make()`` (a ReliefF) fitted first and ``warm`` more
    times, each with its peak memory, then once under the profiler for
    the weight rule's device time.  The fits launch ``must_launch`` (the
    fused engine) or take the discrete engine's ``tier`` with no fused
    launch; where ``ref`` (another phase's scores of the same fit) is
    given the scores are held to it, with equal ``top_features_``, else
    column 0 (planted) ranks first.  Returns its numbers."""
    n, p = X.shape
    y_enc = np.unique(y, return_inverse=True)[1]
    kw = engine_args(make(), y_enc)
    if tier is None:
        plan = rc.block_plan(n, p, dev, "relieff")
        pairs = plan.nb * plan.n_pad
        shape = f"nb {plan.nb} of n_pad {plan.n_pad}"
    else:
        got = rd.discrete_tier(n, p, 3, y_enc, "relieff", kw["class_probs"],
                               device=dev)
        check(got == tier, f"{label}: tier {got}, expected {tier}")
        layout, ti, _ = rd._tiles_and_layout(n, p, 3, y_enc, "relieff",
                                             kw["class_probs"], dev)
        pairs = ti * (rd._round_up(n, ti) if layout is None else layout[4])
        shape = f"tier {tier}, ti {ti}"
    before = launch_counts()
    rd.reset_gemm_ops()
    base = torch.cuda.memory_allocated(dev)
    times, peaks = [], []
    for _ in range(1 + warm):
        est, sec, peak = timed_fit(dev, make(), X, y)
        times.append(sec)
        peaks.append(peak)
    moved = launches_since(before)
    ops = rd.gemm_ops
    rules, device_s = rules_device_s(make, X, y,
                                     BUILD_DIR / f"trace-relieff-{label}")
    s = est.feature_importances_
    check(est.effective_backend_ == dev.type, f"{label}: effective_backend_")
    check(s.shape == (p,) and np.isfinite(s).all(),
          f"{label}: finite scores of shape ({p},)")
    for name in must_launch:
        check(moved[name] > 0, f"{label}: the fit launched {name}")
    check(dev.type != "cuda" or 0 < rules <= device_s,
          f"{label}: the trace holds the rule's device time ({rules} of "
          f"{device_s} s)")
    if tier is not None:
        check(not any(moved.values()) and ops > 0,
              f"{label}: int8 GEMMs ({ops}) and no fused launch ({moved})")
    if ref is None:
        err = "none"
        check(est.top_features_[0] == 0, f"{label}: column 0 ranks first")
    else:
        err = f"{float(np.abs(s - ref).max()):.3e}"
        check(np.allclose(s, ref, rtol=0, atol=fit_tol(ref)),
              f"{label}: max |scores - the earlier fit| {err}")
        ref_top = np.argsort(ref)[::-1][:len(est.top_features_)]
        check(np.array_equal(est.top_features_, ref_top),
              f"{label}: top_features_ {est.top_features_} vs {ref_top}")
    out = dict(first_s=times[0], warm_s=times[1:], peak_gb=max(peaks),
               rules_s=rules, fit_device_s=device_s,
               bytes_per_pair=(max(peaks) * 1e9 - base) / pairs, shape=shape)
    print(f"relieff {label}: ReliefF X {n}x{p} ({shape}); fit "
          f"{times[0]:.4f} s, warm {', '.join(f'{t:.4f}' for t in times[1:])}"
          f" s; peak {max(peaks):.2f} GB ({out['bytes_per_pair']:.1f} B a "
          f"pair over {base / 1e9:.2f} GB held); rule's device time "
          f"{rules:.4f} s of the fit's {device_s:.4f} s in a profiled fit; "
          f"launches {moved}, gemm_ops {ops:.4e}; max |scores - the earlier "
          f"fit| {err} on {SMI}", flush=True)
    return out


def dropin_phase(dev, X, y, ref_scores, backend="gpu"):
    """Phase 26 (b): ``fast_select_torch.MultiSURF(backend='gpu')``, the
    upstream import surface, on phase 4's data: scores equal phase 4's bit
    for bit, and no JAX module in this process."""
    est, sec, peak = timed_fit(
        dev, fast_select_torch.MultiSURF(n_features_to_select=10,
                                         backend=backend), X, y)
    s = est.feature_importances_
    check(est.effective_backend_ == dev.type, "drop-in: effective_backend_")
    check(np.array_equal(s.view(np.int32), ref_scores.view(np.int32)),
          f"drop-in: scores bit for bit phase 4's (max diff "
          f"{np.abs(s - ref_scores).max():.3e})")
    jax_mods = sorted(m for m in sys.modules
                      if m.split(".")[0] in JAX_PACKAGES)
    check(not jax_mods, f"drop-in: JAX modules loaded: {jax_mods[:8]}")
    print(f"drop-in: fast_select_torch.MultiSURF(backend={backend!r}) X "
          f"{X.shape[0]}x{X.shape[1]} fit {sec:.4f} s, peak {peak:.2f} GB; "
          f"scores equal phase 4's bit for bit; no jax or fastselect_tpu in "
          f"sys.modules on {SMI}", flush=True)
    return sec


def example_phase(n=16384, p=65536, backend="cuda",
                  timeout_s=EXAMPLE_TIMEOUT_S):
    """Phase 26 (c): ``examples/torch/gwas_workflow.py`` as users run it,
    in a process of its own with a deadline: it exits 0 and recovers the
    planted signals.  Returns its seconds."""
    script = Path(__file__).resolve().parent / "examples" / "torch" \
        / "gwas_workflow.py"
    cmd = [sys.executable, str(script), "--n", str(n), "--p", str(p),
           "--backend", backend]
    t0 = time.perf_counter()
    r = subprocess.run(cmd, capture_output=True, text=True,
                       timeout=timeout_s)
    sec = time.perf_counter() - t0
    check(r.returncode == 0, f"gwas example: exit {r.returncode}: "
          f"{r.stdout[-1000:]} {r.stderr[-2000:]}")
    check("planted signals recovered: True" in r.stdout,
          f"gwas example: {r.stdout[-2000:]}")
    lines = [ln for ln in r.stdout.splitlines()
             if ln.startswith(("TuRF elimination", "mRMR refinement",
                               "planted signals"))]
    print(f"gwas example: {' '.join(cmd[1:])}: {sec:.2f} s ("
          f"{'; '.join(lines)}) on {SMI}", flush=True)
    return sec


def completeness_phase(dev, X_n, y_n, X_mf, y_mf, large_n_scores, refs,
                       v1_shape=(3000, 5000), example=(16384, 65536)):
    """Phase 26: ReliefF's weight rule at large-n, on the v1 tier and on
    the 150-state mixed input (``refs``: phases 9 and 8's ReliefF scores
    of the first two); the drop-in surface; the GWAS example.  Launches
    are counted over it: all four kernels must launch.  Returns
    (numbers, launches)."""
    t0 = time.perf_counter()
    before = launch_counts()
    cont = ("relief_pass1_cont", "relief_pass2_cont", "relieff_weights")
    mixed = ("relief_pass1_mixed", "relief_pass2_mixed", "relieff_weights")
    res = {"large-n": relieff_rule_fits(
        dev, "large-n", lambda: ReliefF(n_features_to_select=10,
                                        n_neighbors=10), X_n, y_n, cont,
        ref=refs["large-n"])}
    X, y = planted_genotypes(1, *v1_shape, 3)
    res["tier-v1"] = relieff_rule_fits(
        dev, "tier-v1", lambda: ReliefF(n_features_to_select=3,
                                        n_neighbors=5), X, y, tier="v1",
        ref=refs["tier-v1"])
    res["mixed-fused"] = relieff_rule_fits(
        dev, "mixed-fused", lambda: ReliefF(n_features_to_select=10,
                                            discrete_limit=200),
        X_mf, y_mf, mixed)
    backend = "gpu" if dev.type == "cuda" else "cpu"
    res["drop-in_s"] = dropin_phase(dev, X_n, y_n, large_n_scores, backend)
    launches = launches_since(before)
    for name in KERNELS:
        check(launches[name] > 0, f"{name} launched in phase 26")
    res["example_s"] = example_phase(*example,
                                     backend="cuda" if backend == "gpu"
                                     else "cpu")
    res["phase_s"] = time.perf_counter() - t0
    print(f"completeness: phase {res['phase_s']:.2f} s; launches {launches}",
          flush=True)
    return res, launches


# ---------------------------------------------------------------------------
# The kernels alone
# ---------------------------------------------------------------------------

def _instance(mangled, fn):
    """``fn`` with the template arguments of its instance in ``mangled``
    (bool and int arguments, and pass 1's accumulator type), e.g.
    ``partials_kernel<true, 2>`` or ``dist_kernel<true, double>``."""
    m = re.search(r"dist_kernelILb([01])E([fd])E", mangled)
    if m is not None:
        return (f"dist_kernel<{('false', 'true')[int(m.group(1))]}, "
                f"{'float' if m.group(2) == 'f' else 'double'}>")
    fn = fn.replace("ILb0", "<false>").replace("ILb1", "<true>")
    rest = mangled[mangled.index(fn) + len(fn):] if fn in mangled else ""
    m = re.match(r"I((?:L[bi]\d+E)+)E", rest)
    if m is None:
        return fn
    args = [{"b0": "false", "b1": "true"}.get(k + v, v)
            for k, v in re.findall(r"L([bi])(\d+)E", m.group(1))]
    return f"{fn}<{', '.join(args)}>"


def ptxas_usage():
    """Kernel name -> [(function, registers, spill bytes)] from ptxas."""
    out = {name: [] for name in KERNEL_FUNCTIONS}
    for mangled, regs, spill in _build.ptxas_report():
        for name, fns in KERNEL_FUNCTIONS.items():
            fn = next((f for f in fns if f in mangled), None)
            if fn is not None:
                out[name].append((_instance(mangled, fn), regs, spill))
    return out


def held(pass2, out, ref, where):
    """(max |out - ref|, the same over max |ref|) of a kernel's output
    against its plain version's, checked: pass 1 bit for bit, pass 2
    within SCORE_RTOL of max |ref|."""
    err = (out - ref).abs().max().item()
    rel = err / ref.abs().max().item()
    if pass2:
        check(rel <= SCORE_RTOL, f"pass2 {where}: relative err {rel}")
    else:
        check(err == 0, f"pass1 {where}: |D| err {err}")
    return err, rel


def kernel_checks(dev):
    """Each kernel against its plain version on the card: max |error| by
    kernel.  Pass 1 of either kind must equal its plain version bit for
    bit (the feature ranges of ``pass1_splits`` included), and every pass
    2 must be within SCORE_RTOL of its plain version and give the same
    bits over two launches.  The MIXED cases lead with their discrete
    columns (the engine's layout; pass 2 then plans per run), but for one
    whose 4-column steps mix kinds (ragged: 14 discrete columns) and one
    with every third column discrete (interleaved)."""
    err = {k: 0.0 for k in KERNELS}
    # (tag, label, n, p, nb, first row, discrete columns, their stride)
    cases = [(tag, label, 1000, 300, nb, off, 60 if tag == "mixed" else 0, 1)
             for tag in ("cont", "mixed")
             for label, nb, off in (("square", 1000, 0),
                                    ("rectangular", 777, 100))]
    cases += [("cont", "ragged", 1004, 44, 333, 7, 0, 1),
              ("cont", "large-p", 128, 100000, 128, 0, 0, 1),
              ("mixed", "ragged", 1004, 44, 333, 7, 14, 1),
              ("mixed", "large-p", 128, 100000, 128, 0, 30000, 1),
              ("mixed", "interleaved", 1000, 300, 777, 100, 100, 3),
              ("mixed", "all-discrete", 1000, 300, 1000, 0, 300, 1)]
    for tag, label, n, p, nb, off, n_disc, stride in cases:
        mixed = tag == "mixed"
        xp, recip, disc = random_inputs(dev, n, p, n_disc, seed=1,
                                        stride=stride)
        run = n_disc if stride == 1 and n_disc % 4 == 0 else 0
        xi = xp if nb == n else xp[off:off + nb].contiguous()
        k1, k2 = f"relief_pass1_{tag}", f"relief_pass2_{tag}"
        before = launch_counts()
        D = rc.dist_matrix(xp, recip, disc, xi=xi, mixed=mixed)
        D_ref = rc.dist_matrix_ref(xp, recip, disc, xi=xi, mixed=mixed)
        W = torch.rand(nb, n, device=dev) - 0.5
        s = rc.accumulate(xp, W, recip, disc, xi=xi, mixed=mixed, n_disc=run)
        s_again = rc.accumulate(xp, W, recip, disc, xi=xi, mixed=mixed,
                                n_disc=run)
        s_ref = rc.accumulate_ref(xp, W, recip, disc, xi=xi, mixed=mixed)
        where = (f"{tag} {label} xi {nb}x{p} vs xp {n}x{p}"
                 + (f", {n_disc} discrete" if mixed else ""))
        d_err, _ = held(False, D, D_ref, where)
        s_err, s_rel = held(True, s, s_ref, where)
        err[k1] = max(err[k1], d_err)
        err[k2] = max(err[k2], s_err)
        check(torch.equal(s, s_again), f"pass2 {where}: two launches differ")
        check(_build.launches[k1] == before[k1] + 1, f"{k1} counter")
        check(_build.launches[k2] == before[k2] + 2, f"{k2} counter")
        ranges = len(rc.pass1_splits(nb, n, p))
        print(f"kernels {where} ({ranges} feature ranges): max |D - ref| "
              f"{d_err:.3e}, max |s - ref| {s_err:.3e} (relative "
              f"{s_rel:.3e}), pass 2 equal over two launches", flush=True)
        del xp, xi, D, D_ref, W
        torch.cuda.empty_cache()
    return err


def kernel_bound(pass2, nb, n, p):
    """(ms, "operations" or "bytes"): the least time of one launch on an
    H100 at 700 W.  3 FP32 operations a pair-feature (subtract, scale or
    weight, add); each input read once and each output written once."""
    ops_ms = 3 * nb * n * p / FP32_PEAK_FLOPS * 1e3
    nbytes = 4 * ((nb + n) * p + 2 * p + nb * n + (p if pass2 else 0))
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return ((ops_ms, "operations") if ops_ms >= bytes_ms
            else (bytes_ms, "bytes"))


def timed_shapes(dev):
    """The shapes at which the kernels are timed, the main path's first
    (from ``block_plan``): (tag, label, nb, n, p, discrete columns, time
    the plain version).  ``tools/kernel_ab.py`` times the same."""
    ln = rc.block_plan(50000, 100, dev)
    lp = rc.block_plan(100, 100000, dev)
    mx = rc.block_plan(2000, 200, dev, n_disc=40)
    xl = rc.block_plan(150000, 100, dev, n_disc=40)
    return [
        ("cont", "large-n", ln.nb, ln.n_pad, ln.p_pad, 0, True),
        ("cont", "large-n, features padded to 32", ln.nb, ln.n_pad, 128,
         0, False),
        ("cont", "large-p", lp.nb, lp.n_pad, lp.p_pad, 0, True),
        ("cont", "mixed-square continuous half", 16384, 16384, 2048, 0,
         False),
        ("mixed", "mixed-xl focal block", xl.nb, xl.n_pad, xl.p_pad, 40,
         True),
        ("mixed", "mixed-fused", mx.nb, mx.n_pad, mx.p_pad, 40, True),
        ("mixed", "mixed-fused, features padded to 32", mx.nb, mx.n_pad,
         224, 40, True),
        ("mixed", "all-discrete", 4096, 4096, 16384, 16384, False),
    ]


def kernel_timing(dev, err):
    """Kernel name -> one row per timed shape, the main path's first: the
    kernel's time (CUDA events, mean of 10 launches), its bound, its plain
    version's time (where nb * n * p < 1e10 for the MIXED kernels) and,
    for pass 1, that of the one PyTorch call that computes the same D (the
    port never calls it): ``torch.cdist(xi * recip, xp * recip, p=1)``
    on continuous data, ``torch.cdist(xi, xp, p=0)`` at the all-discrete
    shape.  Where the plain version runs, the kernel's output is held
    against it as in ``kernel_checks`` and ``err`` takes its error."""
    timing = {k: [] for k in KERNELS}
    for tag, label, nb, n, p, n_disc, plain in timed_shapes(dev):
        mixed = tag == "mixed"
        xp, recip, disc = random_inputs(dev, n, p, n_disc, seed=2)
        xi = xp[:nb]
        W = torch.rand(nb, n, device=dev) - 0.5
        ref_reps = 2 if nb * n * p >= 10 ** 9 else 5
        runs = {
            "relief_pass1": (
                lambda: rc.dist_matrix(xp, recip, disc, xi=xi, mixed=mixed),
                lambda: rc.dist_matrix_ref(xp, recip, disc, xi=xi,
                                           mixed=mixed)),
            "relief_pass2": (
                lambda: rc.accumulate(xp, W, recip, disc, xi=xi,
                                      mixed=mixed, n_disc=n_disc),
                lambda: rc.accumulate_ref(xp, W, recip, disc, xi=xi,
                                          mixed=mixed)),
        }
        for kname, (kernel, ref) in runs.items():
            key = f"{kname}_{tag}"
            library_ms = lib_name = None
            if key == "relief_pass1_cont":
                xs, ps = xi * recip, xp * recip
                library_ms = cuda_ms(lambda: torch.cdist(xs, ps, p=1), 3)
                lib_name = "torch.cdist(p=1)"
                del xs, ps
                torch.cuda.empty_cache()
            elif key == "relief_pass1_mixed" and n_disc == p:
                library_ms = cuda_ms(lambda: torch.cdist(xi, xp, p=0), 1)
                lib_name = "torch.cdist(p=0)"
                torch.cuda.empty_cache()
            pass2 = kname == "relief_pass2"
            shape = (f"xi {nb}x{p} vs xp {n}x{p}"
                     + (f", {n_disc} discrete" if mixed else ""))
            ms = cuda_ms(kernel, 10)
            plain_ms = max_err = None
            if plain:
                plain_ms = cuda_ms(ref, ref_reps)
                out, want = kernel(), ref()
                max_err, rel = held(pass2, out, want, f"{key} at {label}")
                err[key] = max(err[key], max_err)
                del out, want
            bound_ms, bound_by = kernel_bound(pass2, nb, n, p)
            timing[key].append(dict(
                shape=f"{label}: {shape}", ms=ms, plain_ms=plain_ms,
                bound_ms=bound_ms, bound_by=bound_by,
                share=bound_ms / ms, library_ms=library_ms,
                max_abs_err=max_err))
            lib = ("" if library_ms is None
                   else f", {lib_name} {library_ms:.4f} ms")
            ref_s = ("" if plain_ms is None else
                     f", plain {plain_ms:.4f} ms (max |err| {max_err:.3e}, "
                     f"relative {rel:.3e})")
            print(f"time {key} at {label} ({shape}): kernel {ms:.4f} ms"
                  f"{ref_s}, bound {bound_ms:.4f} ms ({bound_by}), "
                  f"{100 * bound_ms / ms:.1f}% of it{lib}", flush=True)
        del xp, xi, W
        torch.cuda.empty_cache()
    return timing

# ---------------------------------------------------------------------------
# The discrete engine's window kernels (phase 27)
# ---------------------------------------------------------------------------

def eager_window_partials(prods, coeffs, ci, off, w, n_states, total_w,
                          bits=0):
    """The eager chain that ``window_partials`` replaced, as the engine
    ran it before: a zeroed int32 q an operand with its products added in,
    cast, scaled and added into a (TI, S * wp) p_sum, then the focal
    one-hot, ``where`` and two sums.  Timed beside the kernel."""
    ti, sft = prods[0][0].shape
    exact = not total_w.is_floating_point()
    acc = torch.int32 if exact else torch.float32
    p_sum = torch.zeros((ti, sft), dtype=acc, device=ci.device)
    for seg_prods, coeff in zip(prods, coeffs):
        q = torch.zeros((ti, sft), dtype=torch.int32, device=ci.device)
        for prod in seg_prods:
            q += prod
        if coeff is None:
            p_sum = p_sum + q.to(acc)
        else:
            p_sum = p_sum + q.to(acc) * coeff[:, None]
    ai = rd._onehot_flat(rd._gemm_window(ci, off, w, bits), n_states)
    t2 = torch.where(ai > 0, p_sum, 0).sum(dim=0)
    return (total_w - t2.view(n_states, -1).sum(dim=0)).to(
        torch.float32)[:w]


def v_mass(prods, coeffs, ci, off, w, n_states, bits=0):
    """sum_i |v[i, f]| (w,) in float64: the scale of window_partials'
    float32 sums over focal rows."""
    wp = prods[0][0].shape[1] // n_states
    idx = (rd._codes_window(ci, off, w, bits).to(torch.int64) * wp
           + torch.arange(w, device=ci.device))
    v = torch.zeros(idx.shape, dtype=torch.float64, device=ci.device)
    for seg_prods, coeff in zip(prods, coeffs):
        s = sum(q.gather(1, idx).to(torch.float64) for q in seg_prods)
        v += s if coeff is None else s * coeff.to(torch.float64)[:, None]
    return v.abs().sum(dim=0)


def window_data(dev, label, n, width, seed):
    """Phase 27's codes, ``width`` features wide: the headline's (int8, n
    rows in class order) or gwas-gather's (2-bit codes read through an
    index that puts them in class order): (codes, bits, rows or None)."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, 3, (n, width), generator=gen, device=dev,
                          dtype=torch.int8)
    if label == "snp-headline":
        return codes, 0, None
    perm = np.random.RandomState(seed).permutation(n)
    return (rd.stage_codes_packed(codes, 3, dev).packed, 2,
            torch.as_tensor(perm, device=dev))


def window_rules(dev, algo, y, block, ti, seed):
    """Weight rules of focal block ``block`` over samples of labels ``y``
    (in row order), shaped as ``pair_weight_rules`` returns them: (mask
    (ti, n) bool, coefficients (ti,) float32) in its order for ``algo``
    (SURF: near misses, near hits; ReliefF: hits, then the misses of each
    class), each mask random on its rule's support only."""
    gen = torch.Generator(device=dev).manual_seed(seed)
    cls = torch.as_tensor(y, device=dev)
    same = cls[block * ti:(block + 1) * ti, None] == cls[None, :]
    supports = {"multisurf": [same, ~same], "surf": [~same, same],
                "relieff": [same] + [(cls == c)[None, :] & ~same
                                     for c in range(int(y.max()) + 1)]}
    rules = []
    for support in supports[algo]:
        mask = (torch.rand(same.shape, generator=gen, device=dev)
                < 0.02) & support
        r = (torch.ones(ti, device=dev) if algo == "surf" else
             (0.5 + torch.rand(ti, generator=gen, device=dev)) / 64)
        rules.append((mask, r))
    return rules


def window_case(dev, codes, bits, rows, off, w, ti, algo, counts, block,
                v1=False):
    """One window of ``_accumulate_plan`` built as the engine builds it:
    (products, coefficients, focal codes, total_w) of focal block
    ``block`` over rows in classes of ``counts`` (the plan of
    ``_plan_segments`` for the block's class, or the full span where it
    straddles), and the plan's name.  With ``v1``, the window of
    ``_accumulate_discrete`` instead: every rule over all rows, one
    product each (the tier of more than 16 classes)."""
    n = codes.shape[0] if rows is None else rows.shape[0]
    y = np.repeat(np.arange(len(counts)), counts)
    rules = window_rules(dev, algo, y, block, ti, seed=block)
    exact = algo == "surf"
    coeffs = [r.to(torch.int32) if exact else r for _, r in rules]
    total_w = rd._total_weight([m for m, _ in rules], coeffs,
                               torch.int32 if exact else torch.float32)
    aa_t = rd.window_onehot(codes, off, w, 3, bits, rows, transpose=True)
    if v1:
        prods = [[rd._dot_t(m.to(torch.int8), aa_t)] for m, _ in rules]
        where, op_coeffs = f"v1, {len(counts)} classes", coeffs
    else:
        classes, _, segments, block_class, _ = rd._class_sorted_layout(y,
                                                                       ti)
        pos = block_class[block]
        plan = rd._plan_segments(algo, False,
                                 tuple(int(c) for c in classes), pos)
        segs_all = list(segments) + [(0, n)]
        operands = []
        for spec, segs in plan:
            mat, coeff = rd._plan_operand(spec, rules, False)
            operands.append(([rd._segment_operand(mat, *segs_all[q])
                              for q in segs], coeff))
        prods = [[rd._dot_t(op, aa_t[:, r0:r1]) for op, r0, r1 in seg_ops]
                 for seg_ops, _ in operands]
        where = "straddling" if pos is None else f"class {pos}"
        op_coeffs = [c for _, c in operands]
    del rules, aa_t
    blk = slice(block * ti, (block + 1) * ti)
    ci = codes[blk] if rows is None else codes[rows[blk]]
    return (prods, op_coeffs, ci, total_w,
            f"{algo} block {block} ({where}, "
            f"{sum(len(sp) for sp in prods)} products)")


def window_bound_ms(nbytes):
    """The least time to move ``nbytes`` at the card's memory rate."""
    return nbytes / HBM_BYTES_PER_S * 1e3


# phase 27's windows: (label, rows, FT, TI, two and three class counts in
# row order, which place a single-class block first and a straddling one
# second, and the number of classes of a ReliefF window on v1, the tier
# of more than 16 classes)
WINDOWS = (("snp-headline", 16384, 2048, 4096, (7000, 9384),
            (5000, 6000, 5384), 60),
           ("gwas-gather", 8192, 1024, 4096, (5192, 3000),
            (4500, 2000, 1692), 60))


def window_phase(dev, windows=WINDOWS):
    """Phase 27: the window kernels against their plain twins on the card
    at the headline's window (16,384 int8 rows, FT 2,048, TI 4,096) and
    gwas-gather's (8,192 rows of 2-bit codes through a class-order index,
    FT 1,024): window_onehot bit for bit, transposed at FT (pass 2's
    operand), flat at FT (the precomputed one-hot's tile) and at the
    width ``_match_rows`` gives pass 1 (``pass1_width``) over all rows
    and over one focal block; window_partials for MultiSURF on a
    single-class and a straddling block, ReliefF with 3 classes, ReliefF
    on v1 with 60 classes (61 operands) and SURF's exact-int path (bit
    for bit), elsewhere within WINDOW_RTOL of sum_i |v[i, f]| a feature;
    then each timed (CUDA events, mean of 10) beside its twin, the eager
    chain it replaced and its bound.  Returns (max |error| by kernel,
    timed rows by kernel); ``windows`` replaces ``WINDOWS`` for a
    rehearsal at a small size."""
    t0 = time.perf_counter()
    err = {k: 0.0 for k in WINDOW_KERNELS}
    timing = {k: [] for k in WINDOW_KERNELS}
    before = launch_counts(WINDOW_KERNELS)
    for label, n, w, ti, two, three, many in windows:
        fw = rd.pass1_width(n, 3, w, ti)
        codes, bits, rows = window_data(dev, label, n, max(2 * w, fw),
                                        seed=27)
        off = w
        focal = codes[:ti] if rows is None else codes[rows[:ti]]
        # (layout, codes, row index, first feature, width, what it is)
        onehots = [(True, codes, rows, off, w, f"pass 2 operand, {n} rows "
                    f"x {w}"),
                   (False, codes, rows, off, w, f"one-hot tile, {n} rows "
                    f"x {w}"),
                   (False, codes, rows, 0, fw, f"pass 1 window, {n} rows "
                    f"x {fw}"),
                   (False, focal, None, 0, fw, f"pass 1 window, {ti} focal "
                    f"rows x {fw}")]
        for transpose, src, idx, start, width, what in onehots:
            layout = "transposed" if transpose else "flat"
            rows_n = src.shape[0] if idx is None else idx.shape[0]
            got = rd.window_onehot(src, start, width, 3, bits, idx,
                                   transpose=transpose)
            ref = rd.window_onehot_ref(src, start, width, 3, bits, idx,
                                       transpose=transpose)
            check(torch.equal(got, ref), f"window_onehot {label} {layout} "
                  f"{what}: differs from its twin")
            ms = cuda_ms(lambda: rd.window_onehot(
                src, start, width, 3, bits, idx, transpose=transpose), 10)
            plain_ms = cuda_ms(lambda: rd.window_onehot_ref(
                src, start, width, 3, bits, idx, transpose=transpose), 10)
            read = (rows_n * width // (8 // bits if bits else 1)
                    + (0 if idx is None else 8 * rows_n))
            bound = window_bound_ms(read + got.numel())
            timing["window_onehot"].append(dict(
                shape=f"{label} {layout} ({what}"
                      f"{', 2-bit' if bits else ', int8'}"
                      f"{' through an index' if idx is not None else ''})",
                ms=ms, plain_ms=plain_ms, eager_ms=plain_ms, bound_ms=bound,
                bound_by="bytes", share=bound / ms, library_ms=None,
                max_abs_err=0.0))
            print(f"window_onehot {label} {layout} {what} "
                  f"({tuple(got.shape)}): equal to its twin; kernel "
                  f"{ms:.4f} ms, twin (the eager chain it replaced) "
                  f"{plain_ms:.4f} ms, bound {bound:.4f} ms (bytes), "
                  f"{100 * bound / ms:.1f}% of it", flush=True)
            del got, ref
        del focal
        many_counts = np.full(many, n // many)
        many_counts[:n % many] += 1
        cases = [("multisurf", two, 0, False), ("multisurf", two, 1, False),
                 ("relieff", three, 0, False), ("relieff", three, 1, False),
                 ("relieff", tuple(many_counts), 1, True),
                 ("surf", two, 0, False)]
        for algo, counts, block, v1 in cases:
            prods, coeffs, ci, total_w, name = window_case(
                dev, codes, bits, rows, off, w, ti, algo, counts, block, v1)
            # as the engine calls it: the block's table built once
            epilogue = rd.WindowPartials([len(sp) for sp in prods], coeffs,
                                         ci, 3, total_w, bits)
            got = epilogue(prods, off, w)
            again = epilogue(prods, off, w)
            once = rd.window_partials(prods, coeffs, ci, off, w, 3, total_w,
                                      bits)
            ref = rd.window_partials_ref(prods, coeffs, ci, off, w, 3,
                                         total_w, bits)
            eager = eager_window_partials(prods, coeffs, ci, off, w, 3,
                                          total_w, bits)
            check(torch.equal(got, again) and torch.equal(got, once),
                  f"window_partials {label} {name}: launches differ")
            diff = (got - ref).abs()
            if algo == "surf":
                check(torch.equal(got, ref) and torch.equal(got, eager),
                      f"window_partials {label} {name}: exact-int path "
                      f"differs from its twin or the eager chain")
                bound_rel = 0.0
            else:
                mass = v_mass(prods, coeffs, ci, off, w, 3, bits)
                over = diff.to(torch.float64) - WINDOW_RTOL * mass
                check(bool((over <= 0).all()),
                      f"window_partials {label} {name}: |kernel - twin| "
                      f"past {WINDOW_RTOL} sum_i |v| (by {over.max():.3e})")
                check(bool(((eager - ref).abs().to(torch.float64)
                            <= WINDOW_RTOL * mass).all()),
                      f"window_partials {label} {name}: the eager chain "
                      f"past the tolerance")
                bound_rel = float((diff.to(torch.float64)
                                   / mass.clamp_min(1e-30)).max())
            max_err = float(diff.max())
            err["window_partials"] = max(err["window_partials"], max_err)
            line = (f"window_partials {label} {name}: max |kernel - twin| "
                    f"{max_err:.3e} (max over features of |err| / sum_i |v| "
                    f"{bound_rel:.3e}), equal over three launches")
            if block == 0 and algo == "multisurf":
                ms = cuda_ms(lambda: epilogue(prods, off, w), 10)
                plain_ms = cuda_ms(lambda: rd.window_partials_ref(
                    prods, coeffs, ci, off, w, 3, total_w, bits), 10)
                eager_ms = cuda_ms(lambda: eager_window_partials(
                    prods, coeffs, ci, off, w, 3, total_w, bits), 10)
                nbytes = (sum(q.numel() * 4 for sp in prods for q in sp)
                          + ci.shape[0] * w // (8 // bits if bits else 1)
                          + 4 * ti * len(coeffs) + 4 * w)
                bound = window_bound_ms(nbytes)
                timing["window_partials"].append(dict(
                    shape=f"{label} window: TI {ti} x {w} features, "
                          f"{name}", ms=ms, plain_ms=plain_ms,
                    eager_ms=eager_ms, bound_ms=bound, bound_by="bytes",
                    share=bound / ms, library_ms=None, max_abs_err=max_err))
                line += (f"; kernel {ms:.4f} ms, twin {plain_ms:.4f} ms, "
                         f"eager chain {eager_ms:.4f} ms, bound {bound:.4f} "
                         f"ms (bytes), {100 * bound / ms:.1f}% of it")
            print(line, flush=True)
            del prods, ci, got, again, once, ref, eager, epilogue
        del codes, rows
        torch.cuda.empty_cache()
    moved = launches_since(before)
    # the kernels run on the card; on the CPU their twins do
    check(dev.type != "cuda" or all(moved.values()),
          f"phase 27: window kernels launched {moved}")
    print(f"windows: phase {time.perf_counter() - t0:.2f} s on {SMI}",
          flush=True)
    return err, timing


# ---------------------------------------------------------------------------
# The discrete engine's int8 GEMM (phase 30)
# ---------------------------------------------------------------------------

# phase 30's products at the engine's shapes: (label, m, n, k, accumulate,
# form of B: "rows" (n, k) contiguous, "segment" a class segment of k
# columns from column k of pass 2's transposed one-hot, "sym" the rows of
# the symmetric tier's one-hot from the block row on, into its match
# matrix)
GEMM_CASES = (
    ("pass 1, snp-paper's window (6 tiles)", 3840, 30720, 18432, True,
     "rows"),
    ("pass 1 at 2 tiles", 3840, 30720, 6144, True, "rows"),
    ("pass 2, a class segment", 3840, 3072, 15003, False, "segment"),
    ("v2-sym block row (headline)", 4096, 12288, 196608, False, "sym"),
    ("ragged", 48, 204, 80, True, "rows"),
)
# phase 30's full fit: snp-paper's size (the benchmark's flagship)
GEMM_FIT = (30000, 200000)


def exact_product(a, b):
    """a @ b.T exactly: ``torch._int_mm`` where the card's cuBLASLt takes
    the shape, else float64 (exact for these sums)."""
    m, k = a.shape
    if a.device.type != "cuda" or (m > 16 and k % 8 == 0
                                   and b.shape[0] % 8 == 0):
        return torch._int_mm(a.contiguous(), b.t())
    return (a.double() @ b.double().t()).to(torch.int32)


def gemm_operands(dev, m, n, k, form, seed):
    """(A, B, out, (the parent's A, B) or None, a label of the cut) of a
    phase 30 case: 0/1 operands, -1/0/1 for pass 2's rule operand, out a
    view with rows further apart than its width where the engine's is."""
    g = torch.Generator(device=dev).manual_seed(seed)

    def draw(shape, lo=0, hi=2):
        return torch.randint(lo, hi, shape, dtype=torch.int8, device=dev,
                             generator=g)
    parent = None
    if form == "segment":
        n_pad = 30720 if m >= 3840 else 16 * k   # snp-paper's on the card
        mat, aa_t = draw((m, n_pad), -1), draw((n, n_pad))
        a, r0, r1 = rd._segment_operand(mat, k, k)
        op8, p0, p1 = with_threshold(rd, "_SEGMENT_ALIGN", 8,
                                     lambda: rd._segment_operand(mat, k, k))
        b, parent = aa_t[:, r0:r1], (op8, aa_t[:, p0:p1])
        cut = (f"segment [{k}, {2 * k}) of {n_pad} rows: columns "
               f"[{r0}, {r1}), the parent's [{p0}, {p1})")
        out = torch.empty((m, n), dtype=torch.int32, device=dev)
    elif form == "sym":
        hot = draw((m + n, k))
        a, b = hot[m:2 * m], hot[m:]
        match = torch.zeros((m + n, m + n), dtype=torch.int32, device=dev)
        out, cut = match[m:2 * m, m:], f"rows [{m}, {2 * m}) of {m + n}"
    else:
        kp = -(-k // 16) * 16
        a, b = draw((m, kp))[:, :k], draw((n, kp))[:, :k]
        out = torch.randint(-99, 99, (m, -(-n // 4) * 4), device=dev,
                            dtype=torch.int32, generator=g)[:, :n]
        cut = "contiguous"
    return a, b, out, parent, cut


def fit_launches_of(case, shapes):
    """The products of a fit (``shapes``: (m, n, k, accumulate) -> calls,
    from :func:`gemm_fit_bits`) at a phase 30 case's shape: m, n and the
    form alike, and k too unless B is a class segment, whose length
    varies with the class."""
    _, m, n, k, acc, form = case
    return sum(c for (mm, nn, kk, aa), c in shapes.items()
               if (mm, nn, aa) == (m, n, acc)
               and (form == "segment" or kk == k))


def gemm_fit_bits(dev, n, p, seed=30):
    """MultiSURF's discrete engine on (n, p) int8 codes on the card (the
    resident route) through the kernel, and again as the parent computed
    it: every product on ``torch._int_mm``, an int32 add of each pass-1
    window of the parent's width, pass-2 windows of one tile, sizes and
    segments rounded to 8.  Checks
    the scores equal bit for bit and the kernel's launches; returns
    (kernel s, parent s, launches, the kernel fit's products by (m, n, k,
    accumulate))."""
    g = torch.Generator(device=dev).manual_seed(seed)
    codes = torch.randint(0, 3, (n, p), dtype=torch.int8, device=dev,
                          generator=g)
    y = np.random.RandomState(seed).permutation(np.arange(n) % 2)
    layout, ti, ft = rd._tiles_and_layout(n, p, 3, y, "multisurf", None,
                                          dev)
    n_pad, p_pad = layout[4], -(-p // ft) * ft
    windows = -(-p_pad // rd.pass1_width(n_pad, 3, ft, ti))
    windows2 = -(-p_pad // rd.pass2_width(n_pad, ti, 2, 3, ft, dev))
    want_launches = n_pad // ti * (windows + 2 * windows2)

    def fit():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        # ti given: the parent's arithmetic rounds segments to 8, which
        # would move the card's blocks (whole 128-row lines) and the sums
        scores = rd.relief_discrete_scores(None, y, codes=codes, ti=ti,
                                           algo="multisurf", n_states=3)
        torch.cuda.synchronize()
        return scores, time.perf_counter() - t0

    def parent_gemm(a, b, out, *, accumulate=False):
        return rd.int8_gemm_ref(a, b, out, accumulate=accumulate)

    def parent_width(n_rows, n_states, ft, ti):
        return ft * max(1, rd._PASS1_ONEHOT_BYTES // (n_rows * n_states * ft))

    def parent_width2(n_rows, ti, n_products, n_states, ft, device):
        return ft
    kernel, shapes = rd.int8_gemm, collections.Counter()

    def counted_gemm(a, b, out, *, accumulate=False):
        shapes[(a.shape[0], b.shape[0], a.shape[1], accumulate)] += 1
        return kernel(a, b, out, accumulate=accumulate)
    before = launch_counts(("int8_gemm",))
    rd.int8_gemm = counted_gemm
    try:
        got, kernel_s = fit()
    finally:
        rd.int8_gemm = kernel
    launches = launches_since(before)["int8_gemm"]
    saved = rd.int8_gemm, rd.pass1_width, rd.pass2_width
    rd.int8_gemm, rd.pass1_width = parent_gemm, parent_width
    rd.pass2_width = parent_width2
    try:
        ref, parent_s = with_threshold(
            rd, "_GEMM_ALIGN", 8,
            lambda: with_threshold(rd, "_SEGMENT_ALIGN", 8, fit))
    finally:
        rd.int8_gemm, rd.pass1_width, rd.pass2_width = saved
    check(np.array_equal(got.view(np.int32), ref.view(np.int32)),
          f"gemm: the {n} x {p} fit's scores differ from the parent's "
          f"arithmetic in {int((got != ref).sum())} features")
    check(sum(shapes.values()) == want_launches
          and (dev.type != "cuda" or launches == want_launches),
          f"gemm: {sum(shapes.values())} products and {launches} int8_gemm "
          f"launches a {n} x {p} fit, {want_launches} expected")
    del codes
    return kernel_s, parent_s, launches, dict(shapes)


def gemm_phase(dev, cases=GEMM_CASES, fit=GEMM_FIT):
    """Phase 30: the discrete engine's int8 GEMM (``csrc/int8_gemm.cu``)
    against ``torch._int_mm`` on the card, bit for bit, at the engine's
    shapes (``GEMM_CASES``): pass 1's window added into counts that are
    not zero, pass 2's class segment starting off 128 in B rows 32,768
    bytes apart, a v2-sym block row written into its match matrix, a
    ragged small shape; each timed (CUDA events, mean of 10) beside its
    twin (``torch._int_mm``, and the int32 add for pass 1), ``_int_mm``
    alone at the parent's operands (``library_ms``; for the segment also
    at the kernel's 128-byte aligned cut, ``library_aligned_ms``) and its
    bound (2 m n k at the int8 peak).  Then a fit at ``fit`` (n, p),
    snp-paper's size, through the kernel and as the parent computed it
    (``gemm_fit_bits``): the scores bit for bit, and each case's
    launches in it (``launches_a_fit``, :func:`fit_launches_of`).
    Returns (max |error|, timed rows, the fit's numbers)."""
    t0 = time.perf_counter()
    rows = []
    for i, (label, m, n, k, acc, form) in enumerate(cases):
        a, b, out, parent, cut = gemm_operands(dev, m, n, k, form, 30 + i)
        c0 = out.clone()
        got = rd.int8_gemm(a, b, out, accumulate=acc)
        want = exact_product(a, b) + (c0 if acc else 0)
        max_err = int((got.long() - want.long()).abs().max())
        check(max_err == 0, f"int8_gemm {label}: differs from the exact "
              f"product by up to {max_err}")
        if parent is not None:
            check(torch.equal(got, exact_product(*parent)),
                  f"int8_gemm {label}: differs from the parent's product")
        kk = a.shape[1]
        ops = 2.0 * m * n * kk
        ms = cuda_ms(lambda: rd.int8_gemm(a, b, out, accumulate=acc), 10)
        ok_mm = m > 16 and kk % 8 == 0 and n % 8 == 0
        plain_ms = cuda_ms(lambda: rd.int8_gemm_ref(
            a, b, out, accumulate=acc), 10) if ok_mm else None
        pa, pb = parent or (a, b)
        library_ms = cuda_ms(lambda: torch._int_mm(
            pa.contiguous(), pb.t()), 10) if ok_mm else None
        aligned_ms = cuda_ms(lambda: torch._int_mm(a, b.t()), 10) if (
            parent is not None) else None
        bound = ops / (INT8_PEAK_TOPS * 1e12) * 1e3
        rows.append(dict(
            shape=f"{label}: {m} x {n} x {kk}"
                  f"{', accumulating' if acc else ''}, B {cut}",
            ms=ms, plain_ms=plain_ms, library_ms=library_ms,
            library_aligned_ms=aligned_ms, bound_ms=bound,
            bound_by="operations", share=bound / ms,
            tops=ops / ms / 1e9, max_abs_err=max_err))
        fmt = lambda v: "-" if v is None else f"{v:.4f}"  # noqa: E731
        print(f"int8_gemm {rows[-1]['shape']}: equal to _int_mm; kernel "
              f"{ms:.4f} ms ({ops / ms / 1e9:.1f} TOP/s, "
              f"{100 * bound / ms:.1f}% of {INT8_PEAK_TOPS:.0f}), twin "
              f"{fmt(plain_ms)} ms, library_ms {fmt(library_ms)} "
              f"(_int_mm at the parent's operands), library_aligned_ms "
              f"{fmt(aligned_ms)}, bound {bound:.4f} ms", flush=True)
        del a, b, out, parent, c0, got, want
        torch.cuda.empty_cache()
    kernel_s, parent_s, launches, shapes = gemm_fit_bits(dev, *fit)
    for case, row in zip(cases, rows):
        row["launches_a_fit"] = fit_launches_of(case, shapes)
    print(f"int8_gemm fit {fit[0]} x {fit[1]} (v2 resident, MultiSURF): "
          f"scores equal the parent's arithmetic bit for bit; kernel "
          f"{kernel_s:.4f} s ({launches} launches; at each case's shape "
          f"{[row['launches_a_fit'] for row in rows]}; by (m, n, k, "
          f"accumulate) {shapes}), parent's products {parent_s:.4f} s; "
          f"phase {time.perf_counter() - t0:.2f} s on {SMI}", flush=True)
    return ({"int8_gemm": max(row["max_abs_err"] for row in rows)},
            {"int8_gemm": rows},
            dict(kernel_s=kernel_s, parent_s=parent_s, launches=launches))


# ---------------------------------------------------------------------------
# ReliefF's neighbour-pick kernel
# ---------------------------------------------------------------------------

def relieff_block(dev, kind, t, n, n_real, row0, ncls, seed, few=None,
                  n_probs=None):
    """A focal block of ReliefF's rule on ``dev``: (D, yi, vi, iid, y_flat,
    valid_flat, class_probs), rows [row0, row0 + t) of n samples (those
    past n_real padding: label -1, validity 0).  D is ``integer`` (0..39,
    ties everywhere), ``quantised`` (steps of 1/4), ``signed-zeros``
    (0..5, zeros of either sign) or ``float``; ``few`` members of the last
    class; ``n_probs`` cuts class_probs to that many classes."""
    g = torch.Generator(device=dev).manual_seed(seed)
    if kind == "float":
        D = torch.rand((t, n), generator=g, device=dev) * 40
    else:
        top = {"integer": 40, "quantised": 160, "signed-zeros": 6}[kind]
        D = torch.randint(0, top, (t, n), generator=g, device=dev).float()
        if kind == "quantised":
            D /= 4
        if kind == "signed-zeros":
            flip = torch.rand((t, n), generator=g, device=dev) < 0.5
            D = torch.where((D == 0) & flip, -0.0, D)
    rng = np.random.RandomState(seed)
    y = np.full(n, -1, np.int64)
    y[:n_real] = rng.randint(0, ncls, n_real)
    if few is not None:
        y[:n_real][y[:n_real] == ncls - 1] = 0
        y[rng.choice(n_real, few, replace=False)] = ncls - 1
    cp = (np.bincount(y[:n_real], minlength=ncls) / n_real).astype(np.float32)
    if n_probs is not None:
        cp = np.zeros(n_probs, np.float32)
    y_t = torch.from_numpy(y).to(dev)
    valid = (y_t >= 0).float()
    rows = torch.arange(row0, row0 + t, device=dev)
    return (D, y_t[rows], valid[rows], rows, y_t, valid,
            torch.from_numpy(cp).to(dev))


def large_n_block(dev, X, y, algo="relieff"):
    """The first focal block of large-n's fit of ``algo``: pass 1's D of
    ``block_plan``'s nb rows against all samples, and the labels the
    engine stages."""
    n, p = X.shape
    y_enc = np.unique(y, return_inverse=True)[1]
    cp = (np.bincount(y_enc) / n).astype(np.float32)
    plan = rc.block_plan(n, p, dev, algo)
    recip = (1.0 / np.maximum(X.max(0) - X.min(0), 1e-30)).astype(np.float32)
    fl = rc.stage_fused(torch.from_numpy(X), y_enc, recip, np.zeros(p, bool),
                        cp, dev, plan.n_pad, plan.p_pad)
    nb = plan.nb
    D = rc.dist_matrix(fl.xp, fl.recip, fl.disc, xi=fl.xp[:nb], mixed=False)
    return (D, fl.yv[:nb], fl.valid[:nb], torch.arange(nb, device=dev),
            fl.yv, fl.valid, fl.class_probs)


# phase 28's synthetic cases: (label, D kind, rows, samples, real samples,
# first row, classes, k, few, class_probs entries), at large-n's block
# where the shape matters
RELIEFF_CASES = (
    ("tie-heavy, padded rows", "integer", 2944, 50048, 50000, 47104, 3, 10,
     None, None),
    ("60 classes", "quantised", 2944, 50048, 50000, 0, 60, 10, None, None),
    ("70 classes (nine groups)", "integer", 1024, 50048, 50000, 5000, 70, 10,
     None, None),
    ("k = 100", "float", 2944, 50048, 50000, 0, 2, 100, None, None),
    ("few members", "integer", 2944, 50048, 50000, 0, 3, 10, 5, None),
    ("labels past class_probs", "quantised", 2944, 50048, 50000, 0, 3, 10,
     None, 1),
    ("signed zeros", "signed-zeros", 2944, 50048, 50000, 0, 2, 10, None,
     None),
)


def relieff_bound_ms(t, n, n_classes):
    """The least time of one launch on an H100 at 700 W: D read once and W
    written once (8 B a pair), the labels and row operands besides."""
    nbytes = 8 * t * n + 4 * n + t * (4 + 8 + 4 + 4 * (n_classes + 1))
    return nbytes / HBM_BYTES_PER_S * 1e3


def relieff_kernel_phase(dev, large_n, cases=RELIEFF_CASES, reps=10):
    """Phase 28: ReliefF's neighbour-pick kernel (``relieff_weights``)
    against its twin, the sort chain ``_sum_rules(_rules_relieff(...))``,
    bit for bit on the card: at ``large_n`` (a focal block from
    :func:`large_n_block`) and on ``cases``; two launches equal.  Then
    each timed (CUDA events, mean of ``reps``): the whole call, the
    kernel's launch alone and the sort chain (``library_ms``), beside the
    bound.  Returns the timed rows."""
    t0 = time.perf_counter()
    before = _build.launches["relieff_weights"]
    blocks = [("large-n block", large_n, 10)] + [
        (label, relieff_block(dev, kind, t, n, n_real, row0, ncls,
                              seed=28 + i, few=few, n_probs=n_probs), k)
        for i, (label, kind, t, n, n_real, row0, ncls, k, few, n_probs)
        in enumerate(cases)]
    rows = []
    for label, args, k in blocks:
        D, yi, vi, iid, y, valid, cp = args
        t, n = D.shape
        got = relief_mod.relieff_weights(*args[:6], k, cp)
        again = relief_mod.relieff_weights(*args[:6], k, cp)
        twin = relief_mod._sum_rules(relief_mod._rules_relieff(
            *args[:6], k, cp))
        equal = torch.equal(got.view(torch.int32), twin.view(torch.int32))
        diff = int((got.view(torch.int32) != twin.view(torch.int32)).sum())
        check(equal, f"relieff_weights {label}: {diff} values differ from "
              f"the twin")
        check(torch.equal(got, again), f"relieff_weights {label}: launches "
              f"differ")
        picks = int((got != 0).sum())
        del again, twin
        ops = relief_mod._relieff_select_operands(
            *args[:4], relief_mod.relieff_labels(y, valid), k, cp)
        iid64, vi32 = iid.to(torch.int64), vi.float()
        ms = cuda_ms(lambda: relief_mod.relieff_weights(*args[:6], k, cp),
                     reps)
        kernel_ms = cuda_ms(lambda: relief_mod._relieff_launch(
            D, ops[0], ops[1], iid64, vi32, ops[2], k), reps)
        chain_ms = cuda_ms(lambda: relief_mod._sum_rules(
            relief_mod._rules_relieff(*args[:6], k, cp)), min(reps, 3))
        bound = relieff_bound_ms(t, n, cp.shape[0])
        rows.append(dict(shape=f"{label}: {t}x{n}, {cp.shape[0]} classes, "
                               f"k {k}", ms=ms, kernel_ms=kernel_ms,
                         plain_ms=chain_ms, library_ms=chain_ms,
                         bound_ms=bound, bound_by="bytes",
                         share=bound / kernel_ms, picks=picks,
                         max_abs_err=0.0))
        print(f"relieff_weights {label} ({t}x{n}, {cp.shape[0]} classes, k "
              f"{k}, {picks} picks): equal to the sort chain bit for bit; "
              f"call {ms:.4f} ms, kernel {kernel_ms:.4f} ms, sort chain "
              f"{chain_ms:.4f} ms, bound {bound:.4f} ms (bytes), "
              f"{100 * bound / kernel_ms:.1f}% of it", flush=True)
        del got, ops, args, D
        torch.cuda.empty_cache()
    moved = _build.launches["relieff_weights"] - before
    check(dev.type != "cuda" or moved > 0,
          f"phase 28: relieff_weights launched {moved} times")
    print(f"relieff kernel: phase {time.perf_counter() - t0:.2f} s on {SMI}",
          flush=True)
    return rows


# phase 29: the rules of csrc/threshold_rule.cu, (algo, use_star), and how
# many ulps of the float64 row sums' threshold a pair may lie from it and
# take the other side (the order of the float64 sums may decide there)
THRESHOLD_RULES = (("multisurf", False), ("multisurf", True),
                   ("surf", False), ("surf", True))
THRESHOLD_ULPS = 4


def chain_threshold(args, algo):
    """(Dm, the chain's threshold (T,), vmask, hit) of the focal block
    ``args`` (D, yi, vi, iid, y_flat, valid_flat, n_real), as
    ``_rules_multisurf`` and ``_rules_surf`` compute them."""
    D, yi, vi, iid, y, valid, n_real = args
    vmask, hit = relief_mod._pair_masks(D, yi, vi, iid, y, valid)
    Dm, mu, denom = relief_mod._row_mean_stats(
        D, vmask, n_real, relief_mod._row_shift(D, iid, valid))
    if algo == "surf":
        return Dm, mu, vmask, hit
    sum_d2 = torch.linalg.vector_norm(Dm, dim=1).square_()
    var = torch.clamp_min(sum_d2 * denom - mu * mu, 0.0)
    return Dm, mu - 0.5 * torch.sqrt(var), vmask, hit


def near_of(W, vmask, hit):
    """The near mask a W of either rule encodes: near hits and far misses
    weigh less than 0, near misses and far hits more (or 0 off the
    starred rules)."""
    return vmask & ((hit & (W < 0)) | (~hit & (W > 0)))


def rule_weights(near, vmask, hit, algo, star):
    """The chain's W on a given near mask."""
    ones = torch.ones(near.shape[0], dtype=torch.float32, device=near.device)
    if algo == "surf":
        rules = [(near & ~hit, ones), (near & hit, -ones)]
        if star:
            far = vmask & ~near
            rules += [(far & hit, ones), (far & ~hit, -ones)]
        return relief_mod._sum_rules(rules)
    n_hit = (near & hit).sum(dim=1).to(torch.float32)
    n_miss = (near & ~hit).sum(dim=1).to(torch.float32)
    w_miss = 1.0 / torch.clamp_min(n_miss, 1.0)
    rules = [(near & hit, -1.0 / torch.clamp_min(n_hit, 1.0)),
             (near & ~hit, w_miss)]
    if star:
        rules.append((vmask & ~near & ~hit, -w_miss))
    return relief_mod._sum_rules(rules)


def model_threshold(Dm, denom, algo):
    """The kernels' threshold (T,) of the chain's shifted rows ``Dm`` (0
    off the mask) and 1 / (n_real - 1): each row's sum and sum of squares
    in float64 rounded to Dm's dtype, then the chain's formula in it."""
    s1, s2 = (torch.empty(Dm.shape[0], dtype=torch.float64, device=Dm.device)
              for _ in range(2))
    for r0 in range(0, Dm.shape[0], 1024):
        part = Dm[r0:r0 + 1024].to(torch.float64, copy=True)
        s1[r0:r0 + 1024] = part.sum(dim=1)
        s2[r0:r0 + 1024] = part.square_().sum(dim=1)
    mu = s1.to(Dm.dtype) * denom
    if algo == "surf":
        return mu
    var = torch.clamp_min(s2.to(Dm.dtype) * denom - mu * mu, 0.0)
    return mu - 0.5 * torch.sqrt(var)


def threshold_held(W, args, algo, star, ulps=THRESHOLD_ULPS):
    """Hold W, the threshold kernels' pair weights of the focal block
    ``args``, to the chain on the same D: W is the chain's bit for bit on
    every row whose near mask agrees with the chain's; W's near mask is
    that of :func:`model_threshold` (the kernels' float64 row sums) but
    for pairs within ``ulps`` ulps of its threshold, where the order of
    the float64 sums may decide; and W is the rule's W on its own near
    mask.  Where the chain's float32 sums put its threshold off the
    float64 one, the pairs between the two change sides.  Returns (pairs
    that changed sides of the chain's threshold, rows that hold them,
    pairs off the model's side, the criteria W fails)."""
    D, yi, vi, iid, y, valid, n_real = args
    want = relief_mod.chain_rule(y, valid, n_real, None, algo=algo,
                                 use_star=star, k=0)(D, yi, vi, iid)
    if W.dtype != torch.float32 or W.shape != want.shape:
        return 0, 0, 0, [f"W is float32 of shape {tuple(want.shape)}"]
    faults = []
    Dm, thr, vmask, hit = chain_threshold(args, algo)
    moved = near_of(want, vmask, hit)
    if not torch.equal(moved, vmask & (Dm < thr[:, None])):
        faults.append("the chain's W encodes its near mask")
    near = near_of(W, vmask, hit)
    moved.ne_(near)
    rows = moved.any(dim=1)
    pairs = int(moved.sum())
    differ = (W.view(torch.int32) != want.view(torch.int32)).any(dim=1)
    del want, moved
    if bool((differ & ~rows).any()):
        faults.append("W is the chain's bit for bit where the near mask "
                      "agrees")
    thr = model_threshold(Dm, 1.0 / (n_real.to(D.dtype) - 1.0), algo)
    off = (vmask & (Dm < thr[:, None])).ne_(near)
    i, j = torch.nonzero(off, as_tuple=True)
    del off
    if i.numel():
        a = thr.abs()
        ulp = (torch.nextafter(a, torch.full_like(a, math.inf)) - a)[i]
        gap = (Dm[i, j].double() - thr[i].double()).abs()
        if not bool((gap <= ulps * ulp.double()).all()):
            faults.append(f"W's near mask is the float64 sums' but within "
                          f"{ulps} ulps of their threshold")
    del Dm
    if not torch.equal(W.view(torch.int32), rule_weights(
            near, vmask, hit, algo, star).view(torch.int32)):
        faults.append("W is the rule's on its own near mask")
    return pairs, int(rows.sum()), int(i.numel()), faults


def threshold_bound_ms(t, n, d_bytes, kernel):
    """The least time of one launch on an H100 at 700 W: the statistics
    read D once (``d_bytes`` a pair), the weights read D and write W
    (``d_bytes`` + 4 a pair); the labels besides."""
    per_pair = d_bytes if kernel == "threshold_stats" else d_bytes + 4
    return (per_pair * t * n + 4 * n) / HBM_BYTES_PER_S * 1e3


def threshold_kernel_phase(dev, large_n, reps=10):
    """Phase 29: MultiSURF's and SURF's rule kernels (``threshold_weights``,
    ``csrc/threshold_rule.cu``) against the chain they replace,
    ``_sum_rules(pair_weight_rules(...))``, on ``large_n`` (a focal block
    of :func:`large_n_block`, (D, yi, vi, iid, y_flat, valid_flat,
    class_probs)) as float32 and as float64, for each of
    ``THRESHOLD_RULES``: two calls equal, and W held to the chain by
    :func:`threshold_held`.  Then timed (CUDA events, mean of ``reps``):
    each launch alone on the wrapper's own operands, the whole call and
    the chain (``library_ms``, mean of 3), beside each launch's bound in
    bytes.  Returns kernel name -> timed rows."""
    t0 = time.perf_counter()
    before = launch_counts(("threshold_stats", "threshold_weights"))
    D32, yi, vi, iid, y, valid, _ = large_n
    n_real = valid.sum()
    rows = {k: [] for k in before}
    for dtype in (torch.float32, torch.float64):
        D = D32.to(dtype)
        t, n = D.shape
        args = (D, yi, vi, iid, y, valid, n_real)
        for algo, star in THRESHOLD_RULES:
            name = f"{algo}{'*' if star else ''} {str(dtype)[6:]}"
            got = relief_mod.threshold_weights(*args, algo=algo,
                                               use_star=star)
            again = relief_mod.threshold_weights(*args, algo=algo,
                                                 use_star=star)
            check(torch.equal(got, again), f"threshold_weights {name}: "
                  f"launches differ")
            del again
            pairs, moved, off, faults = threshold_held(got, args, algo,
                                                       star)
            del got
            check(not faults, f"threshold_weights {name}: W against the "
                  f"chain ({pairs} pairs in {moved} rows changed sides, "
                  f"{off} off the float64 sums' side): {faults}")
            ops, shift, denom = relief_mod._threshold_operands(*args)
            thr, coef = relief_mod._threshold_stats(
                D, ops, shift, denom, algo == "multisurf", star)
            ms = {"threshold_stats": cuda_ms(
                lambda: relief_mod._threshold_stats(
                    D, ops, shift, denom, algo == "multisurf", star), reps),
                  "threshold_weights": cuda_ms(
                lambda: relief_mod._threshold_launch(D, ops, shift, thr,
                                                     coef), reps)}
            call_ms = cuda_ms(lambda: relief_mod.threshold_weights(
                *args, algo=algo, use_star=star), reps)
            chain_ms = cuda_ms(lambda: relief_mod._sum_rules(
                relief_mod.pair_weight_rules(*args, None, algo=algo,
                                             use_star=star, k=0)),
                min(reps, 3))
            for kernel, kernel_ms in ms.items():
                bound = threshold_bound_ms(t, n, D.element_size(), kernel)
                rows[kernel].append(dict(
                    shape=f"large-n block {name}: {t}x{n}", ms=kernel_ms,
                    kernel_ms=kernel_ms, call_ms=call_ms, plain_ms=chain_ms,
                    library_ms=chain_ms, bound_ms=bound, bound_by="bytes",
                    share=bound / kernel_ms, rows_moved=moved,
                    pairs_moved=pairs, pairs_off_model=off))
            print(f"threshold_weights large-n block {name} ({t}x{n}): "
                  f"{pairs} pairs in {moved} rows changed sides of the "
                  f"chain's threshold, {off} of the float64 sums' (each "
                  f"within {THRESHOLD_ULPS} ulps of it); elsewhere W is the "
                  f"chain's bit for bit; "
                  f"stats {ms['threshold_stats']:.4f} ms, weights "
                  f"{ms['threshold_weights']:.4f} ms, call {call_ms:.4f} "
                  f"ms, chain {chain_ms:.4f} ms, bounds "
                  + ", ".join(f"{threshold_bound_ms(t, n, D.element_size(), k):.4f}"
                              for k in ms)
                  + " ms (bytes)", flush=True)
            del ops, shift, thr, coef
            torch.cuda.empty_cache()
        del D, args
    for kernel, k0 in before.items():
        moved = _build.launches[kernel] - k0
        check(dev.type != "cuda" or moved > 0,
              f"phase 29: {kernel} launched {moved} times")
    print(f"threshold kernels: phase {time.perf_counter() - t0:.2f} s on "
          f"{SMI}", flush=True)
    return rows


# ---------------------------------------------------------------------------

def main():
    t_start = time.perf_counter()
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device is available")

    # plain references on the card run in full float32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    # the mesh phases: four shards on the first card, and every card
    # where there is more than one
    meshes = [[dev] * 4]
    if torch.cuda.device_count() > 1:
        meshes.append([torch.device("cuda", i)
                       for i in range(torch.cuda.device_count())])
    mesh_s = {}

    # 1. environment
    global SMI
    smi = SMI = run(["nvidia-smi", "--query-gpu=name,power.limit",
                     "--format=csv,noheader"]).splitlines()[0]
    nvcc = _build.find_nvcc()
    nvcc_ver = run([nvcc, "--version"]).splitlines()[-1]
    try:
        import triton
        triton_ver = triton.__version__
    except ImportError:
        triton_ver = "not importable"
    print(f"env: torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)} x"
          f"{torch.cuda.device_count()}; nvcc {nvcc} ({nvcc_ver}); "
          f"triton {triton_ver}; TF32 matmul/cudnn off", flush=True)
    print(smi, flush=True)

    # 2. build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.load()
    print(f"build: {time.perf_counter() - t0:.2f} s -> {lib_path} "
          f"(nvcc {' '.join(_build.NVCC_FLAGS)})", flush=True)
    ptxas = ptxas_usage()
    for name, rows in ptxas.items():
        print(f"ptxas {name}: " + "; ".join(
            f"{fn} {regs} registers, {spill} B spilled"
            for fn, regs, spill in rows), flush=True)

    # 3. kernels against their plain versions, then timed
    err = kernel_checks(dev)
    timing = kernel_timing(dev, err)
    # 27. the discrete engine's window kernels against their twins, timed
    window_err, window_timing = window_phase(dev)
    # 30. the discrete engine's int8 GEMM against torch._int_mm, timed,
    # and a snp-paper-size fit against the parent's arithmetic
    gemm_err, gemm_timing, gemm_fit = gemm_phase(dev)

    # 4-6. the main path
    main0 = launch_counts()
    cont = ("relief_pass1_cont", "relief_pass2_cont")
    X_n, y_n = make_classification(n_samples=50000, n_features=100,
                                   n_informative=10, random_state=0)
    X_n = X_n.astype(np.float32)
    large_n, fit_n = fit_phase(dev, "large-n", X_n, y_n, cont, warm=2)
    scores_n = large_n.feature_importances_
    X_p, y_p = make_classification(n_samples=100, n_features=100000,
                                   random_state=0)
    X_p = X_p.astype(np.float32)
    _, fit_p = fit_phase(dev, "large-p", X_p, y_p, cont, warm=3)
    X, y = make_classification(n_samples=2000, n_features=200,
                               n_informative=10, random_state=1)
    X = X.astype(np.float32)
    X[:, :40] = np.random.RandomState(3).randint(0, 3, (2000, 40))
    X[:, 0] = 2 * y              # a strongly relevant discrete column
    est, fit_m, ref_mixed = hybrid_phase(dev, "mixed", X, y)
    check(est.is_discrete_[:40].all() and not est.is_discrete_[40:].any(),
          "mixed: exactly the 40 integer columns are discrete")
    check(est.top_features_[0] == 0, "mixed: the planted column ranks first")
    X[:, 1] = np.arange(2000) % 150   # 150 states: past int8 state codes
    est_mf, fit_mf = fit_phase(dev, "mixed-fused", X, y,
                               ("relief_pass1_mixed", "relief_pass2_mixed"),
                               discrete_limit=200)
    check(est_mf.is_discrete_[:40].all()
          and not est_mf.is_discrete_[40:].any(),
          "mixed-fused: the 40 integer columns are discrete")
    X_mf, y_mf = X, y
    X, y = make_classification(n_samples=150000, n_features=100,
                               n_informative=10, random_state=9)
    X = quantized(X, np.arange(40)).astype(np.float32)
    fit_xl, warm_xl, ref_xl = mixed_xl_phase(dev, X, y)
    del X
    oracle_phase()
    # the mixed phase's reference ran the MIXED kernels and the threshold
    # rule's, mixed-xl's the continuous ones: not the main path (phase 4's
    # plain engine launches nothing)
    main_launches = {k: v - ref_mixed[k] - ref_xl[k]
                     for k, v in launches_since(main0).items()}
    for name in (*KERNELS, "threshold_stats", "threshold_weights"):
        check(main_launches[name] > 0, f"{name} launched on the main path")
    check(main_launches["threshold_stats"]
          == main_launches["threshold_weights"],
          f"the threshold rule's two launches on the main path: "
          f"{main_launches}")
    # 28. ReliefF's neighbour-pick kernel against the sort chain, timed
    rule_timing = {"relieff_weights": relieff_kernel_phase(
        dev, large_n_block(dev, X_n, y_n))}
    # 29. MultiSURF's and SURF's rule kernels against their chain, timed
    rule_timing.update(threshold_kernel_phase(
        dev, large_n_block(dev, X_n, y_n, "multisurf")))

    # 21. the mesh: large-n through the automatic route (the continuous
    # kernels on every shard), the 150-state mixed input called directly
    # (the MIXED kernels)
    t0 = time.perf_counter()
    fit_tol_n = (fit_tol(large_n.feature_importances_), 0.0)
    for mesh in meshes:
        mesh_s["mesh-large-n"] = mesh_fit_phase(
            mesh, "mesh-large-n", lambda: MultiSURF(n_features_to_select=10),
            X_n, y_n, large_n.feature_importances_,
            (psh, "sharded_relief_scores"), "cont", fit_tol_n)
        mesh_s["mesh-mixed"] = mesh_mixed_phase(dev, mesh, X_mf, y_mf,
                                                est_mf)
    print(f"mesh-large-n and mesh-mixed: phase "
          f"{time.perf_counter() - t0:.2f} s", flush=True)

    # 7. the SNP headline on the all-discrete engine
    t0 = time.perf_counter()
    rs = np.random.RandomState(0)
    X = rs.randint(0, 3, (16384, 65536), dtype=np.int8)
    y = rs.randint(0, 2, 16384)
    X[:, 0] = 2 * y
    print(f"headline data: {time.perf_counter() - t0:.2f} s", flush=True)
    head = discrete_phase(dev, "snp-headline",
                          MultiSURF(n_features_to_select=10), X, y,
                          "v2-sym", warm=2)
    eng_s, eng_ops = engine_rate(dev, X, y)
    rate = eng_ops / eng_s / 1e12
    print(f"snp-headline engine alone (codes on the card): {eng_s:.4f} s, "
          f"{eng_ops:.4e} int8 ops, {rate:.1f} TOP/s = "
          f"{100 * rate / INT8_PEAK_TOPS:.2f}% of {INT8_PEAK_TOPS:.0f} "
          f"TOP/s; end to end (first fit) "
          f"{head['gemm_ops'] / head['first_s'] / 1e12:.1f} TOP/s", flush=True)
    head_est = MultiSURF(n_features_to_select=10)
    head_est.feature_importances_ = head["scores"]
    head_est.top_features_ = np.argsort(head["scores"])[::-1][:10]
    dev_int8_s = device_fit_phase(dev, "device-fit int8", X, y, head_est,
                                  min(head["warm_s"]))
    # 21. the mesh: p >= 4n routes the genotypes to the feature shard
    t0 = time.perf_counter()
    for mesh in meshes:
        mesh_s["mesh-snp"] = mesh_fit_phase(
            mesh, "mesh-snp", lambda: MultiSURF(n_features_to_select=10),
            X, y, head["scores"],
            (feature_shard, "feature_sharded_relief_discrete_scores"),
            "gemm", DISC_TOL, warm=0)
    print(f"mesh-snp: phase {time.perf_counter() - t0:.2f} s", flush=True)
    # 24. the GWAS-scale route: the headline's genotypes through the forced
    # routes, then gwas-promote and gwas-gather at the card's own gates
    gwas = gwas_phase(dev, X, y, head)
    X_snp, y_snp = X, y
    del X

    # 8. the other tiers
    X, y = planted_genotypes(1, 3000, 5000, 3)
    relieff_v1 = discrete_phase(dev, "tier-v1",
                                ReliefF(n_features_to_select=3,
                                        n_neighbors=5), X, y, "v1")
    X, y = planted_genotypes(2, 30000, 2048, 2)
    tier_v2 = discrete_phase(dev, "tier-v2",
                             MultiSURF(n_features_to_select=3, use_star=True),
                             X, y, "v2")
    # 21. the mesh: the sample shard with class-sorted blocks dealt to the
    # shards, then the ring (_RING_BYTES below the codes' bytes) with its
    # skip table
    t0 = time.perf_counter()
    make_v2 = lambda: MultiSURF(n_features_to_select=3,  # noqa: E731
                                use_star=True)
    for mesh in meshes:
        mesh_s["mesh-v2"] = mesh_fit_phase(
            mesh, "mesh-v2", make_v2, X, y, tier_v2["scores"],
            (psh, "_sharded_discrete_v2"), "gemm", DISC_TOL, warm=0)
        # the ring's rules run on its shards' rows, not the engine's
        # blocks: float32 row statistics over other shapes may move a
        # threshold by an ulp, so it is held to the referees' FIT_ATOL
        mesh_s["mesh-ring"] = mesh_fit_phase(
            mesh, "mesh-ring", make_v2, X, y, tier_v2["scores"],
            (parallel.ring, "_ring_skip_table"), "gemm",
            (fit_tol(tier_v2["scores"]), 0.0), warm=0,
            ring_bytes=X.size - 1)
    print(f"mesh-v2 and mesh-ring: phase {time.perf_counter() - t0:.2f} s",
          flush=True)
    X_v2, y_v2 = X, y
    X, y = planted_genotypes(3, 8192, 16384, 2)
    tier_sym = discrete_phase(dev, "tier-v2-sym", SURF(n_features_to_select=3),
                              X.astype(np.float64), y, "v2-sym")
    del X

    # 9. SURF and ReliefF on continuous data
    phase9 = launch_counts()
    X, y = make_classification(n_samples=10000, n_features=100,
                               n_informative=10, random_state=4)
    for make, params in ((SURF, {}), (SURF, {"use_star": True}),
                         (ReliefF, {"n_neighbors": 10})):
        fit_phase(dev, "continuous", X.astype(np.float32), y, cont,
                  make=make, **params)
    X, y = make_classification(n_samples=50000, n_features=100,
                               n_informative=10, random_state=0)
    relieff_n, _ = fit_phase(dev, "large-n", X.astype(np.float32), y, cont,
                             make=ReliefF, n_neighbors=10)
    oracle_phase_surf_relieff()
    for name in cont:
        check(launches_since(phase9)[name] > 0,
              f"{name} launched by SURF/ReliefF")
    # ReliefF's kernel on the main path: these fits, their references plain
    main_launches["relieff_weights"] = launches_since(phase9)[
        "relieff_weights"]
    check(main_launches["relieff_weights"] > 0,
          "relieff_weights launched on the main path")

    # 10. the hybrid engine at size
    X, y = make_classification(n_samples=16384, n_features=2048,
                               n_informative=16, random_state=5)
    X = np.hstack([np.random.RandomState(6).randint(0, 3, (16384, 2048)),
                   X]).astype(np.float32)
    X[:, 0] = 2 * y
    _, fit_sq, _ = hybrid_phase(dev, "mixed-square", X, y, warm=1)
    del X
    _, fit_ln, _ = hybrid_phase(dev, "mixed-large-n",
                                quantized(X_n, np.arange(40)), y_n)

    # 11. a float32 tensor fit against the host-array fit, both warm
    large_n, host_n = timed_fit(dev, MultiSURF(n_features_to_select=10),
                                X_n, y_n)[:2]
    dev_n_s = device_fit_phase(dev, "device-fit float32", X_n, y_n,
                               large_n, host_n)

    # 12. TuRF's fast scorers
    X, y = planted_genotypes(7, 4096, 16384, 2)
    turf_phase(dev, "turf-discrete", X, y, "discrete")
    X, y = make_classification(n_samples=10000, n_features=1000,
                               n_informative=10, random_state=8)
    turf_phase(dev, "turf-continuous", X.astype(np.float32), y,
               "continuous")
    turf_phase(dev, "turf-mixed", quantized(X, np.arange(100)).astype(
        np.float32), y, "mixed")
    del X

    # 13. chi2
    chi2_ms, chi2_host_s = chi2_phase(dev, meshes=meshes)

    # 14-17. mRMR and CFS on the contingency tables' int8 GEMMs
    selectors = {label: phase(dev) for label, phase in (
        ("mrmr", mrmr_phase), ("mrmr-stream", mrmr_stream_phase),
        ("cfs", cfs_phase), ("cfs-stream", cfs_stream_phase))}

    # 18-20. MDR on the tables' int8 GEMMs
    mdr, mdr_large, mdr_sec = mdr_phase(dev)
    mdr_k3, k3_sec = mdr_k3_phase(dev)
    mdr_k4, k4_sec = mdr_k4_phase(dev)

    # 21. the mesh: MDR's combos sharded, the MI matrix's pair tiles
    t0 = time.perf_counter()
    for mesh in meshes:
        mesh_s["mesh-mdr"] = mesh_mdr_phase(
            dev, mesh, mdr_k3["X"], mdr_k3["y"], mdr_k3["planted"], mdr_k3)
        mesh_s["mesh-stats"] = mesh_stats_phase(dev, mesh)
    print(f"mesh-mdr and mesh-stats: phase {time.perf_counter() - t0:.2f} s",
          flush=True)

    # 22. profiling: timed_fit, phase records and a trace (under build/)
    t0 = time.perf_counter()
    fit_timing = profiling_phase(dev, X_n, y_n, BUILD_DIR / "trace-large-n")
    print(f"profiling: phase {time.perf_counter() - t0:.2f} s", flush=True)

    # 23. the mesh across processes: four processes on the first card, and
    # the collectives in a one-rank NCCL group
    t0 = time.perf_counter()
    procs_launches = mesh_procs_phase(dev, {
        "X_n": X_n, "y_n": y_n, "X_mf": X_mf, "y_mf": y_mf,
        "X_snp": X_snp, "y_snp": y_snp, "X_v2": X_v2, "y_v2": y_v2,
        "X_k3": mdr_k3["X"], "y_k3": mdr_k3["y"]})
    procs_s = time.perf_counter() - t0
    print(f"mesh-procs: phase {procs_s:.2f} s on {smi}", flush=True)

    # 25. the staging layer: the p >> n point at every transfer_dtype, the
    # stager's chunk widths, the copy seconds of phases 5, 7 and 24
    staged = staging_phase(dev, X_p, y_p, X_snp, gwas)
    del X_snp, X_p

    # 26. completeness: ReliefF's weight rule at large-n, on the v1 tier
    # and on the 150-state input; the drop-in surface; the GWAS example
    complete, complete_launches = completeness_phase(
        dev, X_n, y_n, X_mf, y_mf, scores_n,
        {"large-n": relieff_n.feature_importances_,
         "tier-v1": relieff_v1["scores"]})

    gp, gg = gwas["gwas-promote"], gwas["gwas-gather"]
    summary = {"kernels": [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[name], "max_abs_err": err[name],
         "mesh_procs_launches": procs_launches[name],
         "completeness_launches": complete_launches[name],
         **{k: timing[name][0][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "shape": timing[name][0]["shape"], "shapes": timing[name],
         "registers": [regs for _, regs, _ in ptxas[name]],
         "spill_bytes": [spill for _, _, spill in ptxas[name]]}
        for name, (src, rep) in KERNELS.items()]}
    # the window kernels' launches on the discrete main path: each phase's
    # fits with the counts set to 0 before them and read after them
    window_launches = {
        "snp-headline": head["window_launches"],
        "tier-v1": relieff_v1["window_launches"],
        "tier-v2": tier_v2["window_launches"],
        "tier-v2-sym": tier_sym["window_launches"],
        "gwas": gwas["window_launches"]}
    summary["kernels"] += [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": head["window_launches"][name],
         "max_abs_err": window_err[name],
         "phase_launches": {label: counts[name] for label, counts
                            in window_launches.items()},
         **{k: window_timing[name][0][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
             "eager_ms")},
         "shape": window_timing[name][0]["shape"],
         "shapes": window_timing[name],
         "registers": [regs for _, regs, _ in ptxas[name]],
         "spill_bytes": [spill for _, _, spill in ptxas[name]]}
        for name, (src, rep) in WINDOW_KERNELS.items()]
    summary["kernels"] += [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": main_launches[name],
         "completeness_launches": complete_launches[name],
         **{k: rule_timing[name][0][k] for k in (
             "ms", "kernel_ms", "plain_ms", "bound_ms", "bound_by",
             "library_ms")},
         "shape": rule_timing[name][0]["shape"],
         "shapes": rule_timing[name],
         "registers": [regs for _, regs, _ in ptxas[name]],
         "spill_bytes": [spill for _, _, spill in ptxas[name]]}
        for name, (src, rep) in RULE_KERNELS.items()]
    # the int8 GEMM's launches on the discrete main path: the window
    # kernels' phases and the mesh layouts (phase 21's first mesh)
    gemm_launches = {**window_launches, **MESH_GEMM_LAUNCHES}
    summary["kernels"] += [
        {"name": name, "route": "cuda", "source": src, "replaces": rep,
         "launches": head["window_launches"][name],
         "max_abs_err": gemm_err[name],
         "fit_launches": gemm_fit["launches"],
         "phase_launches": {label: counts[name] for label, counts
                            in gemm_launches.items()},
         **{k: gemm_timing[name][0][k] for k in (
             "ms", "plain_ms", "bound_ms", "bound_by", "library_ms")},
         "shape": gemm_timing[name][0]["shape"],
         "shapes": gemm_timing[name],
         "registers": [regs for _, regs, _ in ptxas[name]],
         "spill_bytes": [spill for _, _, spill in ptxas[name]]}
        for name, (src, rep) in GEMM_KERNELS.items()]
    print(f"fits: large-n {fit_n:.4f} s, large-p {fit_p:.4f} s, mixed "
          f"{fit_m:.4f} s, mixed-fused {fit_mf:.4f} s, mixed-xl "
          f"{fit_xl:.4f} s (warm {', '.join(f'{t:.4f}' for t in warm_xl)} "
          f"s), mixed-square "
          f"{fit_sq:.4f} s, mixed-large-n {fit_ln:.4f} s; snp-headline first "
          f"{head['first_s']:.4f} s, warm "
          f"{', '.join(f'{t:.4f}' for t in head['warm_s'])} s (MIXED route "
          f"{head['mixed_s']:.4f} s); tensor fits int8 {dev_int8_s:.4f} s, "
          f"float32 {dev_n_s:.4f} s (host array {host_n:.4f} s); chi2 "
          f"{chi2_ms:.4f} ms (host {chi2_host_s * 1e3:.4f} ms); "
          + "; ".join(f"{label} first {res['first_s']:.4f} s, warm "
                      f"{res['warm_s'][0]:.4f} s (phase {sec:.2f} s)"
                      for label, (res, sec) in selectors.items())
          + f"; mdr first {mdr['first_s']:.4f} s, warm "
          f"{mdr['warm_s'][0]:.4f} s, mdr-large-n {mdr_large['first_s']:.4f} "
          f"s (phase {mdr_sec:.2f} s); mdr-k3 first {mdr_k3['first_s']:.4f} "
          f"s, warm {mdr_k3['warm_s'][0]:.4f} s (phase {k3_sec:.2f} s); "
          f"mdr-k4 {mdr_k4['first_s']:.4f} s (phase {k4_sec:.2f} s); "
          + ", ".join(f"{k} {v if isinstance(v, float) else v[0]:.4f} s"
                      for k, v in mesh_s.items())
          + f" (first fits on {len(meshes[-1])} shards); mesh-procs phase "
          f"{procs_s:.2f} s; timed_fit large-n {fit_timing.seconds:.4f} s; "
          + ", ".join(f"{k} {v['first_s']:.4f} s (warm {v['warm_s'][0]:.4f} s)"
                      for k, v in gwas["routes"].items())
          + f"; gwas-promote {gp['first_s']:.4f} s (resident "
          f"{gp['resident_s']:.4f} s), gwas-gather {gg['first_s']:.4f} s"
          f" (gwas phase {gwas['phase_s']:.2f} s); staging 100x500000 "
          + ", ".join(f"{td} first {v['first_s']:.4f} s, warm "
                      f"{min(v['warm_s']):.4f} s"
                      for td, v in staged["fits"].items())
          + f" (one-shot {staged['one_shot_s']:.4f} s; phase 25 "
          f"{staged['phase_s']:.2f} s); "
          + "; ".join(f"relieff {label} warm {min(r['warm_s']):.4f} s"
                      for label, r in complete.items()
                      if isinstance(r, dict))
          + f"; drop-in {complete['drop-in_s']:.4f} s; gwas example "
          f"{complete['example_s']:.2f} s (phase 26 "
          f"{complete['phase_s']:.2f} s)"
          + f" on {smi}; chip_smoke {time.perf_counter() - t_start:.1f} s",
          flush=True)
    print("gwas: " + json.dumps({
        "routes": gwas["routes"], "gwas-promote": gp, "gwas-gather": gg,
        "phase_s": gwas["phase_s"]}), flush=True)
    print("staging: " + json.dumps(staged), flush=True)
    print("completeness: " + json.dumps(complete), flush=True)
    print(json.dumps(summary), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}), flush=True)


if __name__ == "__main__":
    sys.exit(main())
