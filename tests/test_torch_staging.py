"""The port's host-to-device staging layer against the JAX package's.

``analyze_features_staged`` (``fastselect_tpu_torch/utils/preprocessing``)
against JAX's ``analyze_features_device`` at every staging dtype, the
estimators' ``transfer_dtype`` contract against JAX's estimators, and the
stager's double-buffer loop (``utils/staging.py``) on a CPU device.  A CUDA
fit's staged route is rehearsed on the CPU by adding 'cpu' to
``_relief_base._STAGED_DEVICE_TYPES``.
"""

import json
import subprocess
import sys

import ml_dtypes
import numpy as np
import pytest
import torch
from numpy.testing import assert_array_equal

import fastselect_tpu
import fastselect_tpu.models._relief_base as JB
import fastselect_tpu_torch
from fastselect_tpu.utils import preprocessing as JP
from fastselect_tpu_torch.interop import estimator_from_jax
from fastselect_tpu_torch.models import _relief_base as TB
from fastselect_tpu_torch.ops import relief_discrete as rd
from fastselect_tpu_torch.ops.relief import relief_scores
from fastselect_tpu_torch.utils import preprocessing as TP
from fastselect_tpu_torch.utils import staging

torch.set_num_threads(2)

DTYPES = ["float32", "float16", "bfloat16"]
HOST_ROUND = {"float32": np.float32, "float16": np.float16,
              "bfloat16": ml_dtypes.bfloat16}
ESTIMATORS = ["MultiSURF", "SURF", "ReliefF"]


def _x(kind, rng, dtype, n=32, p=97):
    """(n, p) X: continuous, mixed (every third column 0..3) or discrete."""
    x = rng.randn(n, p) * 3
    if kind == "mixed":
        x[:, ::3] = rng.randint(0, 4, (n, len(range(0, p, 3))))
    elif kind == "discrete":
        x = rng.randint(0, 5, (n, p)) * 1.5 - 2
    return x.astype(dtype)


def _rounded(x, td):
    """X as the staging dtype gives it back, float32: rounded once."""
    return x.astype(HOST_ROUND[td]).astype(np.float32)


@pytest.mark.parametrize("xdtype", [np.float32, np.float64])
@pytest.mark.parametrize("kind", ["continuous", "mixed", "discrete"])
@pytest.mark.parametrize("td", DTYPES)
def test_analyze_staged_matches_jax(td, kind, xdtype, rng):
    """32 x 97 in chunks of 32 columns (the last ragged): discreteness,
    reciprocal ranges, X and the discrete columns' codes equal JAX's bit
    for bit, n_states equal."""
    x = _x(kind, rng, xdtype)
    ref = JP.analyze_features_device(x, 5, f_chunk=32, transfer_dtype=td)
    got = TP.analyze_features_staged(x, 5, transfer_dtype=td,
                                     device="cpu", f_chunk=32)
    disc = got.is_discrete.numpy()
    assert_array_equal(disc, ref.is_discrete)
    assert disc.any() == (kind != "continuous")
    assert_array_equal(got.recip.numpy(), ref.recip)
    assert got.recip.dtype == torch.float32
    assert got.n_states == ref.n_states
    if ref.codes is None:
        assert got.codes is None
    else:
        assert_array_equal(got.codes.numpy()[:, disc], ref.codes[:, disc])
    if kind == "discrete":
        assert got.x_dev is None      # scored from its codes alone
    else:
        assert got.x_dev.dtype == torch.float32
        assert_array_equal(got.x_dev.numpy(), _rounded(x, td))
    if ref.x_dev is not None:         # where JAX keeps its staged X
        assert_array_equal(got.x_dev.numpy(), np.asarray(ref.x_dev))


@pytest.mark.parametrize("td,value,want", [
    ("float16", 1 + 2**-11 + 2**-40, 1 + 2**-10),
    ("bfloat16", 1 + 2**-8 + 2**-40, 1.0),
    ("bfloat16", 1 + 2**-8 + 2**-30, 1.0)])
def test_staging_rounds_once_as_jax(td, value, want, rng):
    """float64 values on a rounding boundary: the port's staged X is JAX's,
    float16 rounded once by numpy (torch would round to float32 first and
    give 1.0); bfloat16 through float32 as ml_dtypes does."""
    x = rng.rand(6, 9) + 3.0
    x[2, 4] = value
    ref = JP.analyze_features_device(x, 2, f_chunk=4, transfer_dtype=td)
    got = TP.analyze_features_staged(x, 2, transfer_dtype=td,
                                     device="cpu", f_chunk=4)
    assert got.x_dev[2, 4].item() == want
    assert_array_equal(got.x_dev.numpy(), np.asarray(ref.x_dev))
    assert_array_equal(got.recip.numpy(), ref.recip)


def test_resolve_transfer_dtype_matches_jax():
    for td, want in ((None, torch.float32), ("float32", torch.float32),
                     ("float16", torch.float16),
                     ("bfloat16", torch.bfloat16)):
        assert TP.resolve_transfer_dtype(td) == want
        assert np.dtype(JP._resolve_transfer_dtype(td)).itemsize \
            == want.itemsize
    for bad in ("int8", "fp16", np.float16, 16, ["float16"]):
        with pytest.raises(ValueError) as ref:
            JP._resolve_transfer_dtype(bad)
        with pytest.raises(ValueError) as got:
            TP.resolve_transfer_dtype(bad)
        assert str(got.value) == str(ref.value)


# ---------------------------------------------------------------------------
# The estimators' contract
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("est", ESTIMATORS)
def test_transfer_dtype_validation_matches_jax(est, rng):
    X, y = rng.rand(30, 8), np.arange(30) % 2
    with pytest.raises(ValueError) as ref:
        getattr(fastselect_tpu, est)(transfer_dtype="int8").fit(X, y)
    with pytest.raises(ValueError) as got:
        getattr(fastselect_tpu_torch, est)(transfer_dtype="int8").fit(X, y)
    assert str(got.value) == str(ref.value)
    assert "transfer_dtype" in str(got.value)


@pytest.mark.parametrize("td", [None, "float32", "float16", "bfloat16"])
@pytest.mark.parametrize("est", ESTIMATORS)
def test_get_params_match_jax(est, td):
    ref = getattr(fastselect_tpu, est)(transfer_dtype=td).get_params()
    assert getattr(fastselect_tpu_torch, est)(
        transfer_dtype=td).get_params() == ref
    assert getattr(fastselect_tpu_torch, est)().get_params() \
        == getattr(fastselect_tpu, est)().get_params()


@pytest.mark.parametrize("est", ESTIMATORS)
def test_estimator_from_jax_carries_transfer_dtype(est, rng):
    X, y = rng.rand(40, 12), rng.randint(0, 2, 40)
    ref = getattr(fastselect_tpu, est)(
        n_features_to_select=4, backend="cpu",
        transfer_dtype="float16").fit(X, y)
    port = estimator_from_jax(ref)
    assert port.transfer_dtype == "float16"
    assert port.get_params() == ref.get_params()
    assert_array_equal(port.transform(X), ref.transform(X))


@pytest.fixture
def staged_cpu(monkeypatch):
    """A CPU fit of host X takes the staged route, as a CUDA fit does."""
    monkeypatch.setattr(TB, "_STAGED_DEVICE_TYPES", ("cuda", "cpu"))


@pytest.mark.parametrize("case", ["float", "under", "genotypes",
                                  "cpu-backend"])
def test_transfer_dtype_attribute_where_jax_sets_it(case, monkeypatch,
                                                    staged_cpu, rng):
    """``transfer_dtype_`` is set by a staged fit (a host float X of at
    least 2**22 values bound for the accelerator) and by nothing else, in
    both packages: JAX's bound for a TPU, the port's for a CUDA device."""
    monkeypatch.setattr(JB, "tpu_available", lambda: True)
    n, p = 64, 1 << 16
    if case == "under":
        p -= 1
    X = rng.rand(n, p).astype(np.float32)
    if case == "genotypes":
        X = rng.randint(0, 3, (n, p)).astype(np.int8)
    y = np.arange(n) % 2
    backend = "cpu" if case == "cpu-backend" else "auto"
    if case == "cpu-backend":
        monkeypatch.setattr(TB, "_STAGED_DEVICE_TYPES", ("cuda",))
    ref = fastselect_tpu.MultiSURF(n_features_to_select=3, backend=backend)
    got = fastselect_tpu_torch.MultiSURF(n_features_to_select=3,
                                         backend=backend)
    if case == "genotypes":
        ref.fit(X, y)
        got.fit(X, y)
    else:   # the analyses alone: JAX's CPU engine is slow at this size
        ref._analyze(X)
        got._analysis(X, torch.device("cpu"))
    assert hasattr(got, "transfer_dtype_") == hasattr(ref, "transfer_dtype_")
    assert hasattr(got, "transfer_dtype_") == (case == "float")
    if case == "float":
        assert got.transfer_dtype_ == ref.transfer_dtype_ == "float32"


@pytest.mark.parametrize("auto", [True, False])
def test_staging_dtype_auto_policy(auto, monkeypatch):
    """JAX's rule: None auto-selects float16 only for large p >> n float
    matrices, explicit values always win, ints never auto-stage half
    width; where the rule does not hold (``_AUTO_HALF_WIDTH``, decided on
    the card) None stages float32.  Thresholds lowered as JAX's test
    lowers them."""
    monkeypatch.setattr(TB, "_AUTO_HALF_WIDTH", auto)
    big_wide = np.zeros((10, 400), np.float32)     # p >= 4n
    big_tall = np.zeros((400, 10), np.float32)
    big_int = np.zeros((10, 400), np.int32)
    for mod in (JB, TB):
        monkeypatch.setattr(mod, "_AUTO_F16_MIN_ELEMS", 1 << 24)
    ref, got = fastselect_tpu.MultiSURF(), fastselect_tpu_torch.MultiSURF()
    assert got._staging_dtype(big_wide) is ref._staging_dtype(big_wide) \
        is None
    assert got.transfer_dtype_ == ref.transfer_dtype_ == "float32"
    for mod in (JB, TB):
        monkeypatch.setattr(mod, "_AUTO_F16_MIN_ELEMS", 1000)
    for X in (big_wide, big_tall, big_int):
        want = ref._staging_dtype(X)
        assert got._staging_dtype(X) == (want if auto else None)
        assert got.transfer_dtype_ == (ref.transfer_dtype_ if auto
                                       else "float32")
    assert ref._staging_dtype(big_wide) == "float16"
    for td in DTYPES:
        ref, got = (fastselect_tpu.MultiSURF(transfer_dtype=td),
                    fastselect_tpu_torch.MultiSURF(transfer_dtype=td))
        assert got._staging_dtype(big_wide) == ref._staging_dtype(
            big_wide) == td
        assert got.transfer_dtype_ == ref.transfer_dtype_ == td


def test_auto_rule_verbose_string_matches_jax(monkeypatch, capsys):
    monkeypatch.setattr(TB, "_AUTO_HALF_WIDTH", True)
    for mod in (JB, TB):
        monkeypatch.setattr(mod, "_AUTO_F16_MIN_ELEMS", 1000)
    x = np.zeros((10, 400))
    fastselect_tpu.MultiSURF(verbose=True)._staging_dtype(x)
    ref = capsys.readouterr().out
    fastselect_tpu_torch.MultiSURF(verbose=True)._staging_dtype(x)
    assert capsys.readouterr().out == ref != ""


def _scores_of(analysis, X32, y, est):
    """The engine on an analysis and a float32 X, as the fit calls it."""
    return relief_scores(
        None if X32 is None else torch.from_numpy(X32), y,
        analysis.recip, analysis.is_discrete, algo=est._algo_name.lower(),
        device=torch.device("cpu"), codes=analysis.codes,
        n_states=analysis.n_states, from_host=True,
        **({"n_neighbors": est.n_neighbors, "class_probs": (
            np.bincount(y) / len(y)).astype(np.float32)}
           if est._algo_name == "ReliefF" else {}))


@pytest.mark.parametrize("td", ["float32", "float16", "bfloat16"])
@pytest.mark.parametrize("case", ["continuous", "mixed", "large-n",
                                  "large-bytes"])
def test_half_width_scores_what_jax_scores(case, td, monkeypatch,
                                           staged_cpu, rng):
    """Float32 staging scores its one staged copy.  Half-width staging
    scores the staged copy only where JAX would (every column continuous,
    n and n p bytes within JAX's limits, lowered here for large-n and
    large-bytes): the fit then equals a float32 fit of X rounded on the
    host bit for bit.  Elsewhere the analysis is the rounded values' and
    the engine scores a float32 copy of X, counted in ``uploads``."""
    monkeypatch.setattr(TB, "_STAGED_MIN_ELEMS", 1)
    if case == "large-n":
        monkeypatch.setattr(TB, "_HALF_WIDTH_MAX_N", 39)
    if case == "large-bytes":
        monkeypatch.setattr(TB, "_HALF_WIDTH_MAX_BYTES", 40 * 30 * 4 - 1)
    X = _x("mixed" if case == "mixed" else "continuous", rng, np.float64,
           n=40, p=30)
    y = rng.randint(0, 2, 40)
    TB.reset_upload_count()
    got = fastselect_tpu_torch.SURF(n_features_to_select=5, backend="cpu",
                                    transfer_dtype=td).fit(X, y)
    assert got.transfer_dtype_ == td
    second = td != "float32" and case != "continuous"
    assert TB.uploads == 1 + second
    if not second:
        same = fastselect_tpu_torch.SURF(
            n_features_to_select=5, backend="cpu",
            transfer_dtype="float32").fit(_rounded(X, td), y)
        assert_array_equal(got.feature_importances_,
                           same.feature_importances_)
        return
    analysis = TP.analyze_features_staged(X, 10, transfer_dtype=td,
                                          device="cpu")
    want = _scores_of(analysis, X.astype(np.float32), y, got)
    assert_array_equal(got.feature_importances_, want)
    assert_array_equal(got.is_discrete_, analysis.is_discrete.numpy())


@pytest.mark.parametrize("est", ESTIMATORS)
def test_staged_float32_fit_equals_one_shot(est, monkeypatch, staged_cpu,
                                            rng):
    """A staged float32 fit scores what today's one-shot copy scores."""
    X = _x("mixed", rng, np.float64, n=48, p=40)
    y = rng.randint(0, 2, 48)
    kw = dict(n_features_to_select=6, backend="cpu")
    one_shot = getattr(fastselect_tpu_torch, est)(**kw).fit(X, y)
    monkeypatch.setattr(TB, "_STAGED_MIN_ELEMS", 1)
    monkeypatch.setattr(staging, "_CHUNK_BYTES", 48 * 7 * 4)  # 6 chunks
    staged = getattr(fastselect_tpu_torch, est)(**kw).fit(X, y)
    assert staged.transfer_dtype_ == "float32"
    assert not hasattr(one_shot, "transfer_dtype_")
    assert_array_equal(staged.feature_importances_,
                       one_shot.feature_importances_)


def test_turf_scorer_stages_float32(monkeypatch, staged_cpu, rng):
    """TuRF's fast scorer stages X at float32 whatever the base estimator's
    transfer_dtype says, and sets no transfer_dtype_ (JAX's fast scorers
    device-put float32 X)."""
    monkeypatch.setattr(TB, "_STAGED_MIN_ELEMS", 1)
    X = _x("continuous", rng, np.float64, n=40, p=24)
    y = rng.randint(0, 2, 40)
    base = fastselect_tpu_torch.MultiSURF(backend="cpu",
                                          transfer_dtype="float16")
    scorer = base._column_scorer(X, y)
    active = np.arange(0, 24, 2)
    want = fastselect_tpu_torch.MultiSURF(backend="cpu").fit(
        X[:, active], y).feature_importances_
    assert_array_equal(scorer(active), want)
    assert not hasattr(base, "transfer_dtype_")


def test_port_never_imports_ml_dtypes():
    """A bfloat16-staged fit in a fresh interpreter imports neither JAX
    nor ml_dtypes."""
    code = """
import json, sys
import numpy as np
import fastselect_tpu_torch as ft
from fastselect_tpu_torch.models import _relief_base as TB
TB._STAGED_DEVICE_TYPES = ("cuda", "cpu")
TB._STAGED_MIN_ELEMS = 1
rng = np.random.RandomState(0)
m = ft.MultiSURF(n_features_to_select=3, backend="cpu",
                 transfer_dtype="bfloat16").fit(rng.rand(30, 12),
                                                 np.arange(30) % 2)
print(json.dumps({"td": m.transfer_dtype_,
                  "mods": [k for k in ("jax", "ml_dtypes", "fastselect_tpu")
                           if k in sys.modules]}))
"""
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, check=True)
    assert json.loads(out.stdout.splitlines()[-1]) == {"td": "bfloat16",
                                                       "mods": []}


# ---------------------------------------------------------------------------
# The stager on a CPU device
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("td", DTYPES + ["int8"])
def test_stager_double_buffer_loop(td, rng):
    """Five chunks (column slices of C-order X, so strided; the last
    narrower) through the two buffers: each comes back cast as it was
    asked, the buffers alternate and are reused, and the loop cannot be
    entered twice at once."""
    dtype = getattr(torch, td)
    x = rng.randn(7, 45) * 4
    st = staging.Stager(torch.device("cpu"))
    chunks = [x[:, f0:f0 + 10] for f0 in range(0, 45, 10)]
    buffers = []
    got = []
    loop = st.stage(iter(chunks), dtype)
    for chunk in loop:
        buffers.append([b.data_ptr() if b is not None else None
                        for b in st.buffers])
        got.append(chunk)
        with pytest.raises(RuntimeError, match="already running"):
            next(st.stage(iter(chunks), dtype))
    assert not st.busy
    assert len(got) == 5 and got[-1].shape == (7, 5)
    for src, chunk in zip(chunks, got):
        assert chunk.dtype == dtype and chunk.is_contiguous()
        want = (src.astype(HOST_ROUND[td]).astype(np.float64)
                if td in HOST_ROUND else src.astype(np.int8))
        assert_array_equal(chunk.to(torch.float64).numpy(), want)
    assert buffers[0][1] is None and buffers[1][1] is not None
    assert {b[0] for b in buffers} == {buffers[0][0]}   # slot 0 reused
    assert {b[1] for b in buffers[1:]} == {buffers[1][1]}


def test_stager_grows_a_buffer_for_a_wider_chunk(rng):
    st = staging.Stager(torch.device("cpu"))
    small, wide = rng.rand(4, 3), rng.rand(4, 50)
    out = list(st.stage(iter([small, small, wide]), torch.float32))
    assert st.buffers[0].numel() == wide.size * 4
    assert st.buffers[1].numel() == small.size * 4
    assert_array_equal(out[2].numpy(), wide.astype(np.float32))


@pytest.mark.parametrize("dtype", [np.int8, np.uint8, np.int32])
def test_upload_rows_ragged(dtype, monkeypatch, rng):
    """``upload`` stages rows in chunks of ``_CHUNK_BYTES`` (7 rows here, the
    last ragged) into one tensor; ``to_device`` on the CPU keeps X's own
    memory where the dtype is X's."""
    monkeypatch.setattr(staging, "_CHUNK_BYTES", 7 * 13)
    x = rng.randint(0, 100, (30, 13)).astype(dtype)
    got = staging.upload(x, "cpu", torch.int8)
    assert got.dtype == torch.int8
    assert_array_equal(got.numpy(), x.astype(np.int8))
    same = staging.to_device(x, "cpu")
    assert same.data_ptr() == x.ctypes.data
    assert_array_equal(staging.to_device(x, "cpu", torch.int8).numpy(),
                       x.astype(np.int8))
    assert [len(c) for c in staging.row_chunks(x, torch.int8)] \
        == [7, 7, 7, 7, 2]


def test_staged_codes_pack_as_before(monkeypatch, rng):
    """Host codes staged a few rows at a time pack to the same bytes as the
    codes packed whole."""
    monkeypatch.setattr(staging, "_CHUNK_BYTES", 5 * 101)
    codes = rng.randint(0, 3, (23, 101)).astype(np.int8)
    staged = rd.stage_codes_packed(codes, 3, "cpu")
    whole = rd.stage_codes_packed(torch.from_numpy(codes), 3, "cpu")
    assert (staged.bits, staged.n, staged.p) == (whole.bits, 23, 101)
    assert torch.equal(staged.packed, whole.packed)
    many = rd.stage_codes_packed(codes, 40, "cpu")   # too many to pack
    assert torch.equal(many, torch.from_numpy(codes))


def test_staging_logs_its_steps(caplog, rng):
    """At INFO the staged analysis logs its cast, copy and analysis
    seconds and the whole sweep as phase records."""
    x = rng.rand(10, 30)
    with caplog.at_level("INFO", logger="fastselect_tpu_torch"):
        TP.analyze_features_staged(x, 5, transfer_dtype="float16",
                                   device="cpu", f_chunk=7)
    names = [r.getMessage().split(":")[0] for r in caplog.records]
    assert names == ["staging.cast", "staging.h2d", "staging.analysis",
                     "staging.analyze"]


@pytest.mark.parametrize("auto", [True, False])
def test_chip_phase_25_rehearses(auto, monkeypatch, staged_cpu):
    """chip_smoke.py's phase 25 at a small size on the CPU, the staged route
    and the auto rule's gate lowered to it: every transfer_dtype's fit
    held to the one-shot fit or the fit of host-rounded X bit for bit,
    the chunk widths and the copy seconds read."""
    import chip_smoke as cs
    from fastselect_tpu_torch import _build
    from fastselect_tpu_torch.ops import relief_cuda as rc
    for name in ("synchronize", "reset_peak_memory_stats"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    # the plain passes counted as the kernels' launches (the fused engine
    # binds its passes as keyword defaults)
    for pass_no, name in ((1, "dist_matrix"), (2, "accumulate")):
        orig = getattr(rc, name)

        def counted(*a, _orig=orig, _pass=pass_no, **k):
            _build.launches[f"relief_pass{_pass}_"
                        f"{'mixed' if k['mixed'] else 'cont'}"] += 1
            return _orig(*a, **k)
        monkeypatch.setitem(rc.relief_fused_scores.__kwdefaults__,
                            f"_pass{pass_no}", counted)
    monkeypatch.setattr(TB, "_STAGED_MIN_ELEMS", 1000)
    monkeypatch.setattr(TB, "_AUTO_F16_MIN_ELEMS", 4000)
    monkeypatch.setattr(TB, "_AUTO_HALF_WIDTH", auto)
    monkeypatch.setattr(cs, "CHUNK_SWEEP", (1 << 12, 1 << 14))
    X_p, y_p = cs.make_classification(n_samples=20, n_features=300,
                                      random_state=0)
    X_snp = np.random.RandomState(1).randint(0, 3, (40, 500), dtype=np.int8)
    gwas = {"gwas-promote": {"phases": [("relief_discrete.h2d", 1.0)]}}
    out = cs.staging_phase(torch.device("cpu"), X_p.astype(np.float32), y_p,
                           X_snp, gwas, shape=(20, 400))
    assert out["fits"]["None"]["used"] == ("float16" if auto else "float32")
    assert {k: v["used"] for k, v in out["fits"].items()
            if k != "None"} == {"float32": "float32", "float16": "float16",
                                "bfloat16": "bfloat16"}
    names = [n for n, _ in out["fits"]["float16"]["records"]]
    assert names == ["staging.cast", "staging.h2d", "staging.analysis",
                     "staging.analyze"]
    assert len(out["sweep"]) == 2
    assert [n for n, _ in out["codes"]["records"]] == ["staging.cast",
                                                        "staging.h2d"]
