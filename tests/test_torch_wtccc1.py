"""The card's block plan of the discrete engine and the WTCCC1 case-control
deployment (``portbench/configs/wtccc1.json``), on the CPU.

On a CUDA device the v2 engines cover n samples with the fewest focal
blocks of at most the JAX package's TI rows, equal and whole 128-row lines
(``relief_discrete._block_rows``); on the CPU the plan stays the JAX
package's.  Scores under the card's plan are held to the plain reference
(``portbench/reference/relief.py``) and to the JAX package at its own TI:
atol 3e-6, rtol 1e-5 with equal rankings, as ``tests/test_engines.py``
holds the v2 tiers; match counts exactly.
"""

import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import fastselect_tpu.ops.relief_discrete as JD
import fastselect_tpu_torch.ops.relief_discrete as TD
from fastselect_tpu_torch import MultiSURF
from portbench import harness
from portbench.data import generate
from portbench.reference.relief import relief_scores

torch.set_num_threads(2)

CUDA, CPU = torch.device("cuda"), torch.device("cpu")
ATOL, RTOL = 3e-6, 1e-5
WTCCC1 = harness.load_cell("wtccc1.multisurf-resident").config


def _case_control(n, p, n_cases, seed=0):
    """int8 genotypes with one planted SNP, and 0/1 labels with n_cases
    ones."""
    rng = np.random.RandomState(seed)
    y = np.zeros(n, np.int64)
    y[rng.permutation(n)[:n_cases]] = 1
    codes = rng.randint(0, 3, (n, p)).astype(np.int8)
    codes[:, 3] = np.where(rng.rand(n) < 0.4, y, codes[:, 3])
    return codes, y


# ---------------------------------------------------------------------------
# The plan
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n,ti,n_pad", [
    (5000, 2560, 5120),       # WTCCC1: 2 x 2,560, not 2 x 4,096
    (30000, 3840, 30720),     # snp-paper: 8 x 3,840, not 8 x 4,096
    (98304, 4096, 98304),     # the north star: 24 x 4,096 as before
    (4097, 2176, 4352),
    (4096, 4096, 4096),
])
def test_card_plan(n, ti, n_pad):
    y = (np.arange(n) < n * 2 // 5).astype(np.int64)
    layout, got_ti, ft = TD._tiles_and_layout(n, 2048, 3, y, "multisurf",
                                              None, CUDA)
    assert (got_ti, layout[4]) == (ti, n_pad)
    assert ti % TD._SEGMENT_ALIGN == 0 and n_pad - n < ti
    assert ft % TD._GEMM_ALIGN == 0


def test_cpu_plan_is_the_jax_package_s():
    for n in (4096, 4097, 5000, 30000, 98304):
        y = np.arange(n) % 2
        layout, ti, _ = TD._tiles_and_layout(n, 2048, 3, y, "multisurf",
                                             None, CPU)
        assert ti == TD._discrete_tile_sizes(n, 2048, 3)[0] \
            == JD._discrete_tile_sizes(n, 2048, 3)[0]
        assert layout[4] == JD._round_up(n, ti)


def test_given_ti_wins_and_v1_keeps_its_size():
    y = np.arange(5000) % 2
    layout, ti, _ = TD._tiles_and_layout(5000, 2048, 3, y, "multisurf",
                                         None, CUDA, ti=1024)
    assert (ti, layout[4]) == (1024, 5120)
    for n in (10, 1000, 4095):     # below _V2_MIN_N: one block, as before
        layout, ti, _ = TD._tiles_and_layout(n, 2048, 3, np.arange(n) % 2,
                                             "multisurf", None, CUDA)
        assert layout is None
        assert ti == TD._gemm_size(TD._discrete_tile_sizes(n, 2048, 3)[0],
                                   CUDA)


def test_wtccc1_tier_and_plan_on_the_card():
    n, p = WTCCC1["n_samples"], WTCCC1["n_features"]
    y = (np.arange(n) < WTCCC1["n_cases"]).astype(np.int64)
    assert TD.discrete_tier(n, p, 3, y, "multisurf", device="cuda",
                            source="tensor") == "v2"
    layout, ti, ft = TD._tiles_and_layout(n, p, 3, y, "multisurf", None,
                                          CUDA)
    assert (ti, ft, layout[4]) == (2560, 1024, 5120)
    # controls fill block 0; block 1 holds both classes and the padding
    assert layout[3] == [0, None]
    # the symmetric tier's one-hot stays past its budget at n_pad 5,120
    assert not TD._sym_zone(layout[4], p, 3)


@pytest.mark.parametrize("n_rows,ti,n_products,ft,want", [
    (5120, 2560, 2, 1024, 3072),     # WTCCC1: 3 tiles a pass-2 window
    (30720, 3840, 2, 1024, 1024),    # snp-paper: one, as before
    (16384, 4096, 2, 2048, 2048),    # the headline: one
    (8192, 4096, 2, 1024, 2048),     # gwas-gather: two
    (1 << 20, 4096, 9, 1024, 1024),  # past the budget: still one
])
def test_pass2_width_on_the_card(n_rows, ti, n_products, ft, want):
    assert TD.pass2_width(n_rows, ti, n_products, 3, ft, CUDA) == want
    assert TD.pass2_width(n_rows, ti, n_products, 3, ft, CPU) == ft
    # the window's transposed one-hot and products stay in the budget
    if want > ft:
        assert 3 * want * (n_rows + 4 * n_products * ti) \
            <= TD._PASS1_ONEHOT_BYTES


@pytest.mark.parametrize("algo,star", [("multisurf", False),
                                       ("surf", True), ("relieff", False)])
def test_wide_pass2_windows_give_the_one_tile_scores(algo, star,
                                                     monkeypatch):
    """Pass-2 windows of five 128-feature tiles (the last one ragged:
    700 features in 640 + 128) give the scores of one-tile windows: the
    card's window width moves no score."""
    monkeypatch.setattr(TD, "_V2_MIN_N", 16)
    monkeypatch.setattr(TD, "_SYM_ONEHOT_BYTES", 0)   # v2, not v2-sym
    monkeypatch.setattr(TD, "_discrete_tile_sizes", lambda n, p, s: (64, 128))
    codes, y = _case_control(150, 700, 60, seed=5)
    cp = np.bincount(y).astype(np.float32) / len(y)
    kw = dict(algo=algo, use_star=star, codes=codes, n_states=3,
              class_probs=cp, n_neighbors=10)
    one = TD.relief_discrete_scores(None, y, **kw)
    widths = []

    def five_tiles(n_rows, ti, n_products, n_states, ft, device):
        widths.append(5 * ft)
        return 5 * ft
    monkeypatch.setattr(TD, "pass2_width", five_tiles)
    wide = TD.relief_discrete_scores(None, y, **kw)
    assert widths == [640] * 3            # one call a focal block
    assert_allclose(wide, one, rtol=1e-6, atol=1e-9)
    assert_array_equal(np.argsort(wide), np.argsort(one))


# ---------------------------------------------------------------------------
# Scores under the card's plan
# ---------------------------------------------------------------------------

def test_card_plan_scores_match_the_reference():
    """4,200 x 96 genotypes, 2:3 classes, in the card plan's two blocks of
    2,176 (a straddling block, 152 padded rows), against the plain
    float64 reference; the match counts against an exact product."""
    n, p = 4200, 96
    codes, y = _case_control(n, p, 1680)
    ti = TD._block_rows(n, TD._discrete_tile_sizes(n, p, 3)[0], CUDA)
    assert ti == 2176
    got = TD.relief_discrete_scores(None, y, algo="multisurf", codes=codes,
                                    n_states=3, ti=ti)
    ref = relief_scores(codes, [y], algo="multisurf")[0]
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()
    assert_array_equal(np.argsort(got)[-10:], np.argsort(ref)[-10:])
    layout, _, ft = TD._tiles_and_layout(n, p, 3, y, "multisurf", None,
                                         CPU, ti=ti)
    cpad = TD._apply_layout(torch.from_numpy(codes), y, layout[1],
                            layout[4], TD._round_up(p, ft))[0]
    hot = [(cpad == s).to(torch.float64) for s in range(3)]
    want = sum(h @ h.t() for h in hot).to(torch.int32)
    for b in range(layout[4] // ti):
        rows = slice(b * ti, (b + 1) * ti)
        assert torch.equal(TD._match_rows(cpad[rows], cpad, ft, 3),
                           want[rows])


def test_layout_puts_each_row_in_its_sorted_place():
    """The class-sorted copy, written row by row in place, equals a
    gather of the rows in class order, padding included."""
    codes, y = _case_control(50, 13, 20, seed=2)
    perm = np.argsort(y, kind="stable")
    x = torch.from_numpy(codes)
    cpad, yv, valid = TD._apply_layout(x, y, perm, 64, 16)
    want = torch.zeros((64, 16), dtype=torch.int8)
    want[:50, :13] = x[torch.from_numpy(perm)]
    assert torch.equal(cpad, want)
    assert_array_equal(yv[:50].numpy(), y[perm])
    assert (yv[50:] == -1).all() and valid.sum() == 50


@pytest.mark.parametrize("algo,star", [("multisurf", False),
                                       ("multisurf", True), ("surf", False),
                                       ("relieff", False)])
def test_card_plan_scores_match_jax(algo, star, monkeypatch):
    """The card's rule at a block cap of 512 (both packages' v2 gate
    lowered): 700 samples in two blocks of 384, one straddling the 2:3
    class boundary, against the JAX package's one block of 704."""
    for mod in (TD, JD):
        monkeypatch.setattr(mod, "_V2_MIN_N", 1)
    n, p = 700, 96
    codes, y = _case_control(n, p, 280, seed=1)
    ti = TD._block_rows(n, 512, CUDA)
    assert ti == 384
    cp = np.bincount(y).astype(np.float32) / n
    kw = dict(algo=algo, use_star=star, codes=codes, n_states=3,
              class_probs=cp, n_neighbors=10)
    got = TD.relief_discrete_scores(None, y, ti=ti, **kw)
    want = JD.relief_discrete_scores(None, y, **kw)
    assert got.dtype == np.float32 and got.shape == want.shape
    assert_allclose(got, want, atol=ATOL, rtol=RTOL)
    assert_array_equal(np.argsort(got)[-10:], np.argsort(want)[-10:])
    if algo != "relieff":     # ReliefF's scores here hold near-ties
        assert_array_equal(np.argsort(got), np.argsort(want))


# ---------------------------------------------------------------------------
# Tracing: padded rows and the straddling blocks
# ---------------------------------------------------------------------------

@pytest.fixture
def info_log(caplog):
    caplog.set_level("INFO", logger="fastselect_tpu_torch")
    return caplog


def _traced_fit(info_log, monkeypatch, y, ti):
    monkeypatch.setattr(TD, "_V2_MIN_N", 16)
    monkeypatch.setattr(TD, "_discrete_tile_sizes",
                        lambda n, p, s: (ti, 128))
    codes = np.random.RandomState(3).randint(0, 3, (len(y), 40))
    MultiSURF(backend="cpu").fit(codes.astype(np.int8), y)
    records = info_log.records
    names = [r.getMessage().split(":")[0] for r in records]
    root = records[names.index("fit[MultiSURF]")]
    spans = {}
    for r in records:
        spans.setdefault(r.getMessage().split(":")[0], []).extend(
            getattr(r, "spans", ()))
    return root, spans


def test_straddling_blocks_are_a_span_inside_pass2(info_log, monkeypatch):
    """72 samples in blocks of 32 (n_pad 96), 40 controls then 32 cases:
    block 1 holds both, block 2 the cases and 24 padded rows."""
    y = np.r_[np.zeros(40), np.ones(32)].astype(np.int64)
    root, spans = _traced_fit(info_log, monkeypatch, y, 32)
    assert root.counts["padded_rows"] == 24
    assert root.counts["focal_blocks"] == 3
    (straddle,) = spans["discrete.straddle"]
    pass2 = [sp[0] for sp in spans["discrete.pass2"]]
    assert len(pass2) == 3 and straddle[1] == pass2[1]
    assert 0 <= straddle[4]


def test_no_straddle_span_when_blocks_hold_one_class(info_log, monkeypatch):
    y = np.r_[np.zeros(32), np.ones(32)].astype(np.int64)
    root, spans = _traced_fit(info_log, monkeypatch, y, 32)
    assert "padded_rows" not in root.counts       # n_pad = n: no delta
    assert len(spans["discrete.pass2"]) == 2
    assert "discrete.straddle" not in spans


def test_v1_counts_its_padded_rows(info_log):
    """v1 (below ``_V2_MIN_N``): 60 rows in one block of 64, no straddle
    span (v1 contracts every block over all samples)."""
    codes = np.random.RandomState(4).randint(0, 3, (60, 12)).astype(np.int8)
    MultiSURF(backend="cpu").fit(codes, np.arange(60) % 2)
    records = info_log.records
    names = [r.getMessage().split(":")[0] for r in records]
    assert records[names.index("fit[MultiSURF]")].counts["padded_rows"] == 4
    assert "discrete.straddle" not in names


# ---------------------------------------------------------------------------
# The case-control generator
# ---------------------------------------------------------------------------

def test_case_control_cohort():
    """WTCCC1's cohort at its own n (5,000, 2,000 cases a phenotype) and
    200 SNPs: genotypes 0..2, the same data for a seed, and every planted
    SNP among the reference's top 10 of its phenotype."""
    cfg = dict(WTCCC1, n_features=200, phenotypes=2)
    seed = 2**31 + 99
    d = generate(cfg, seed, "cpu")
    again = generate(cfg, seed, "cpu")
    x = d.variants[0][0]
    assert x.dtype == torch.int8 and tuple(x.shape) == (5000, 200)
    assert int(x.min()) == 0 and int(x.max()) == 2
    assert torch.equal(x, again.variants[0][0])
    assert not torch.equal(x, generate(cfg, seed + 1, "cpu").variants[0][0])
    assert all(v[0] is x for v in d.variants)
    # minor-allele frequencies inside U(0.05, 0.5), up to sampling
    q = x.double().mean(dim=0) / 2
    assert 0.03 < float(q.min()) and float(q.max()) < 0.55
    refs = relief_scores(x, [y for _, y in d.variants], algo="multisurf")
    for (_, y), (_, y2), cols, ref in zip(d.variants, again.variants,
                                          d.planted, refs):
        assert_array_equal(y, y2)
        assert np.bincount(y).tolist() == [3000, 2000]
        assert set(cols) <= set(np.argsort(ref)[::-1][:10].tolist())
