"""The port's contingency tables and MI library against the JAX package's,
on the CPU.

Tables are exact integers in both packages, so the port's int8 GEMM
builders, its plain bincount builders and JAX's jitted bf16 builders must
agree exactly, at 2, 5 and more than 127 states (int32 codes).  The
statistics are float32 summed in another order, so the matrices agree
within rtol 1e-5 and atol 1e-7, JAX's own tolerance against its oracle
(``tests/test_contingency.py``).  The port's matrices are bitwise
symmetric with a zero diagonal where JAX's are.  Fixtures stay below 1024
features, where JAX's ``pairwise_stat_matrix`` takes its one-device path.
"""

import math

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

from fastselect_tpu.ops import contingency as J
from fastselect_tpu.ops import mi as jmi
from fastselect_tpu_torch import mutual_information
from fastselect_tpu_torch.ops import contingency as C
from fastselect_tpu_torch.ops import relief_discrete as rd

from oracles import mi_pair_bits, su_pair

torch.set_num_threads(2)

RTOL, ATOL = 1e-5, 1e-7
STATES = [2, 5, 130]
# At 2 states each MI is a sum of four float32 terms p * log(ratio) with
# p near 1/4, and JAX's value is itself up to 2.7e-7 from the float64
# statistic of the same tables (test_matrices_match_jax[2-mi]'s fixture):
# XLA's log and division round otherwise than torch's, in 27-40% of the
# entries.  Agreement there is held to float32's noise at 4 terms.
ATOL_BINARY = 4e-7

_jax_pair_tables = jax.jit(J.pair_tables, static_argnames="s")


def _codes(seed, n, p, s):
    rng = np.random.RandomState(seed)
    return (rng.randint(0, s, (n, p)).astype(np.int32),
            rng.randint(0, s, n).astype(np.int32))


@pytest.mark.parametrize("s", STATES)
def test_feature_target_tables_exact(s):
    X, y = _codes(1, 97, 40, s)
    got = C.feature_target_tables(X, y, s, s)
    assert got.dtype == torch.int32 and got.shape == (40, s, s)
    assert_array_equal(got.numpy(), J.feature_target_tables(X, y, s, s))
    assert torch.equal(got, C.feature_target_tables_ref(X, y, s, s))
    staged = C.StagedColumnStats(X, s)
    assert torch.equal(staged.tables_vs(y, s), got)


@pytest.mark.parametrize("s", STATES)
def test_pair_tables_exact(s):
    X, _ = _codes(2, 83, 45, s)
    Xi, Xj = X[:, :13], X[:, 13:]
    got = C.pair_tables(C.stage_codes(Xi, s), C.stage_codes(Xj, s), 83, s=s)
    assert got.shape == (13, 32, s, s)
    want = np.asarray(_jax_pair_tables(Xi, Xj, np.float32(83), s=s))
    assert_array_equal(got.numpy(), want)
    assert torch.equal(got, C.pair_tables_ref(Xi, Xj, s=s))


@pytest.mark.parametrize("s", STATES)
def test_pair_tables_same_tile(s):
    """One staged tile against itself: the diagonal tables are each
    feature's self-table."""
    X, _ = _codes(3, 50, 20, s)
    xt = C.stage_codes(X, s)
    got = C.pair_tables(xt, xt, 50, s=s)
    assert torch.equal(got, C.pair_tables_ref(X, X, s=s))


@pytest.mark.parametrize("stat", ["mi", "su"])
@pytest.mark.parametrize("s", STATES)
def test_matrices_match_jax(s, stat):
    X, _ = _codes(4, 90, 37, s)
    got = C.pairwise_stat_matrix(X, s, stat)
    want = J.pairwise_stat_matrix(X, s, stat, device=None)
    assert_allclose(got, want, rtol=RTOL,
                    atol=ATOL_BINARY if s == 2 else ATOL)
    assert_array_equal(got, got.T)
    R, p = C.pairwise_stat_matrix_device(X, s, stat)
    assert p == 37 and R.dtype == torch.float32
    dev = R.numpy().astype(np.float64)
    assert_array_equal(dev, dev.T)
    assert_array_equal(np.diag(dev), 0.0)
    off = ~np.eye(37, dtype=bool)
    assert_array_equal(dev[off], got[off])
    for j in (0, 11, 36):
        assert_array_equal(C.matrix_column(R, j, p), dev[:, j])


def test_pairwise_matrix_state0_drop_matches_oracle():
    """tests/test_contingency.py's oracle case through the port."""
    rng = np.random.RandomState(0)
    n, p, s = 120, 17, 5
    X = rng.randint(0, s, (n, p)).astype(np.int32)
    got = C.pairwise_stat_matrix(X, s, "mi")
    for i in range(p):
        for j in range(p):
            assert abs(got[i, j] - mi_pair_bits(X[:, i], X[:, j])) < 1e-5
    assert_array_equal(got, got.T)


def test_su_matrix_matches_oracle():
    rng = np.random.RandomState(0)
    X = rng.randint(0, 5, (50, 6)).astype(np.int32)
    su = C.pairwise_stat_matrix(X, 5, "su")
    for i in range(6):
        for j in range(i + 1, 6):
            assert abs(su[i, j] - su_pair(X[:, i], X[:, j])) < 1e-4


@pytest.mark.parametrize("stat", ["mi", "su"])
@pytest.mark.parametrize("s", [2, 6, 130])
def test_staged_columns_match_full_matrix(s, stat):
    """Streamed columns (state-0-dropped at s >= 3) against the full
    matrix's, and against JAX's staged columns."""
    X, _ = _codes(5, 90, 40, s)
    full = C.pairwise_stat_matrix(X, s, stat)
    staged = C.StagedColumnStats(X, s)
    jstaged = J.StagedColumnStats(X, s, device=None)
    for j in (0, 7, 39):
        col = staged.column(j, stat)
        assert col.dtype == np.float64
        assert_allclose(col, full[:, j], rtol=1e-6, atol=1e-12)
        assert_allclose(col, jstaged.column(j, stat), rtol=RTOL,
                        atol=ATOL_BINARY if s == 2 else ATOL)
        assert_array_equal(col, C.pairwise_stat_columns(X, X[:, j], s,
                                                        stat))


def test_staged_binary_target():
    """s = 2 keeps the full contraction (tests/test_contingency.py)."""
    X, y = _codes(0, 60, 12, 2)
    staged = C.StagedColumnStats(X, 2)
    rel = staged.stats_vs(y, 2, "mi")
    one = C.pairwise_stat_columns(
        np.concatenate([X, y[:, None]], axis=1), y, 2, "mi")
    assert_allclose(rel, one[:12], rtol=1e-6, atol=1e-12)
    jrel = J.StagedColumnStats(X, 2, device=None).stats_vs(y, 2, "mi")
    assert_allclose(rel, jrel, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("stat", ["mi", "su"])
def test_staged_relevance_equals_full_builder(stat):
    """The streamed path's relevance (state-0-dropped tables) is the full
    builder's bit for bit: the tables are equal and reduce alike."""
    X, y = _codes(6, 77, 50, 5)
    full = C.tables_stat(C.feature_target_tables(X, y, 5, 5), 77, stat)
    streamed = C.StagedColumnStats(X, 5).stats_vs(y, 5, stat)
    assert_array_equal(streamed, full.numpy().astype(np.float64))


@pytest.mark.parametrize("tiles", [(32, 64), (32, 96)])
@pytest.mark.parametrize("s", STATES)
def test_tile_size_changes_no_entry(s, tiles):
    """Each entry comes from its own table: two tilings give the same
    matrix, bit for bit."""
    X, _ = _codes(7, 64, 150, s)
    xt = C.stage_codes(X, s)
    a, b = (C._mirror(C._pair_blocks(xt, 64, s, "mi", math.log(2.0),
                                     tile=t)) for t in tiles)
    assert torch.equal(a, b)
    ta = C.pair_tables(xt[:tiles[0]], xt, 64, s=s)
    tb = C.pair_tables(xt[:tiles[1]], xt, 64, s=s)
    assert torch.equal(ta, tb[:tiles[0]])


@pytest.mark.parametrize("n,p,s", [(2000, 5000, 5), (5000, 2000, 10),
                                   (100, 50, 200), (10 ** 6, 30, 3)])
def test_tiles_meet_the_gemm_rules(n, p, s):
    """Tiles hold whole multiples of 32 features, so every product has
    more than 16 rows and N a multiple of 8; the table block and one-hot
    stay within their budgets."""
    t = C.pair_tile(n, p, s)
    assert t % 32 == 0 and 32 <= t <= 1024
    assert t * t * s * s * 4 <= C._TABLE_BYTES or t == 32
    v = C._vector_tile(C._round_up(n, 8), p, s)
    assert v % 32 == 0 and v >= 32


def test_every_table_is_a_counted_int8_gemm(monkeypatch):
    """Each table goes through torch._int_mm with the GEMM's rules: K a
    multiple of 8, A with more than 16 rows, N a multiple of 8; padded
    samples and states weigh nothing (n = 97)."""
    shapes = []
    real = torch._int_mm

    def spy(a, b):
        assert a.dtype == b.dtype == torch.int8
        assert a.shape[0] > 16 and a.shape[1] % 8 == 0
        assert b.shape[1] % 8 == 0 and b.stride(0) == 1  # column-major B
        shapes.append((a.shape[0], a.shape[1], b.shape[1]))
        return real(a, b)

    monkeypatch.setattr(torch, "_int_mm", spy)
    X, y = _codes(8, 97, 70, 5)
    rd.reset_gemm_ops()
    C.pairwise_stat_matrix_device(X, 5, "mi")
    C.feature_target_tables(X, y, 5, 5)
    C.StagedColumnStats(X, 5).column(3, "su")
    assert rd.gemm_ops == sum(2 * m * k * n for m, k, n in shapes)
    nt = -(-70 // C.pair_tile(97, 70, 5))
    assert len(shapes) == nt * (nt + 1) // 2 + 1 + 1
    rd.reset_gemm_ops()


@pytest.mark.parametrize("s", [2, 5, 9])
def test_statistics_match_jax(s):
    rng = np.random.RandomState(s)
    tables = rng.randint(0, 30, (64, s, s)).astype(np.float32)
    tables[0] = 0.0
    tables[1, :, 1:] = 0.0
    n = np.float32(tables.sum((1, 2)).max())
    t = torch.from_numpy(tables)
    nt = torch.tensor(n)
    for unit in (math.log(2.0), 1.0):
        assert_allclose(C.mi_from_tables(t, nt, unit).numpy(),
                        np.asarray(J.mi_tables_reduce(tables, n, unit)),
                        rtol=RTOL, atol=ATOL)
    assert_allclose(C.su_from_tables(t, nt).numpy(),
                    np.asarray(J.su_tables_reduce(tables, n)),
                    rtol=RTOL, atol=ATOL)
    counts = tables[:, 0]
    assert_allclose(C.entropy_from_counts(torch.from_numpy(counts)).numpy(),
                    np.asarray(jax.jit(J.entropy_from_counts)(counts)),
                    rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# The MI library (tests/test_mrmr.py's cases through both packages)
# ---------------------------------------------------------------------------

@pytest.fixture
def discrete_data():
    rng = np.random.RandomState(0)
    return rng.randint(0, 4, (60, 9)), rng.randint(0, 3, 60)


@pytest.mark.parametrize("unit", ["bit", "nat"])
def test_mi_single_pair(discrete_data, unit):
    X, y = discrete_data
    got = mutual_information.calculate_mi_single_pair(X[:, 0], y,
                                                      backend="cpu",
                                                      unit=unit)
    want = jmi.calculate_mi_single_pair(X[:, 0], y, backend="cpu", unit=unit)
    assert isinstance(got, float)
    assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    scale = 1.0 if unit == "bit" else math.log(2.0)
    assert abs(got - scale * mi_pair_bits(X[:, 0], y)) < 1e-4


@pytest.mark.parametrize("unit", ["bit", "nat"])
def test_mi_matrices_match_jax_and_oracle(discrete_data, unit):
    X, y = discrete_data
    rel, red = mutual_information.calculate_mi_matrices(X, y, backend="cpu",
                                                        unit=unit)
    rel_j, red_j = jmi.calculate_mi_matrices(X, y, backend="cpu", unit=unit)
    assert_allclose(rel, rel_j, rtol=RTOL, atol=ATOL)
    assert_allclose(red, red_j, rtol=RTOL, atol=ATOL)
    assert_array_equal(red, red.T)
    assert_array_equal(np.diag(red), 0.0)
    assert_array_equal(
        rel, mutual_information.calculate_mi_matrices(X, y, backend="cpu",
                                                      unit=unit)[0])
    from fastselect_tpu_torch.ops.mi import calculate_mi_relevance
    assert_array_equal(calculate_mi_relevance(X, y, backend="cpu",
                                              unit=unit), rel)
    if unit == "bit":
        oracle = [mi_pair_bits(X[:, f], y) for f in range(X.shape[1])]
        assert_allclose(rel, oracle, atol=1e-4)


@pytest.mark.parametrize("call", [
    lambda m: m.calculate_mi_single_pair(np.array([0.5, 1.0]),
                                         np.array([1, 0])),
    lambda m: m.calculate_mi_matrices(np.array([[0.5, 1.0]]),
                                      np.array([1]), backend="cpu"),
])
def test_mi_rejects_float(call):
    with pytest.raises(ValueError, match="integer"):
        call(mutual_information)


def test_mi_rejects_negative():
    with pytest.raises(ValueError, match="negative"):
        mutual_information.calculate_mi_matrices(
            np.array([[-1, 0], [1, 2]]), np.array([0, 1]), backend="cpu")


def test_mi_backends():
    x = np.array([0, 1, 1, 0])
    with pytest.raises(ValueError, match="backend"):
        mutual_information.calculate_mi_single_pair(x, x, backend="tpu")
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA"):
            mutual_information.calculate_mi_single_pair(x, x, backend="gpu")
    assert mutual_information.calculate_mi_single_pair(
        x, x, backend="auto") == pytest.approx(1.0, abs=1e-6)
