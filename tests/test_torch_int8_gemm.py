"""The discrete engine's int8 GEMM (``relief_discrete.int8_gemm``): its
plain twin against int64 matmul on the CPU, the wrapper's checks, and
the engine's products through it.  The tests marked ``card`` hold the
kernel (``csrc/int8_gemm.cu``) to ``torch._int_mm`` on a CUDA device and
skip without one; this file imports no JAX."""

import time

import numpy as np
import pytest
import torch

import chip_smoke as cs
import fastselect_tpu_torch.ops.relief_discrete as TD
from fastselect_tpu_torch import _build

torch.set_num_threads(2)


def _int8(rng, shape, lo=-1, hi=2):
    return torch.from_numpy(rng.randint(lo, hi, shape).astype(np.int8))


def _want(a, b, c0=None):
    """a @ b.T in int64, plus c0 where given."""
    want = a.long() @ b.long().t()
    return want if c0 is None else want + c0.long()


# (m, n, k): ragged in every dimension, past the kernel's 128 x 256 x 128
# tile on some
SHAPES = [(5, 7, 3), (33, 40, 100), (48, 203, 144), (130, 260, 300),
          (16, 1, 17)]


@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("m,n,k", SHAPES)
def test_twin_equals_int64_matmul(m, n, k, accumulate, rng):
    """Both forms, on ragged shapes, into an output whose rows lie further
    apart than its width, added to counts that are not zero."""
    a, b = _int8(rng, (m, k)), _int8(rng, (n, k))
    wide = torch.from_numpy(rng.randint(-9, 9, (m, n + 5)).astype(np.int32))
    out = wide[:, :n]
    c0, tail = out.clone(), wide[:, n:].clone()
    got = TD.int8_gemm(a, b, out, accumulate=accumulate)
    assert got is out
    assert torch.equal(out.long(), _want(a, b, c0 if accumulate else None))
    assert torch.equal(wide[:, n:], tail)


@pytest.mark.parametrize("accumulate", [False, True])
def test_twin_reads_a_strided_b(accumulate, rng):
    """B as pass 2 cuts it, ``aa_t[:, r0:r1]``: rows n_pad bytes apart."""
    aa_t = _int8(rng, (48, 512), 0, 2)
    a = _int8(rng, (40, 96))
    out = torch.from_numpy(rng.randint(-5, 5, (40, 48)).astype(np.int32))
    c0 = out.clone()
    TD.int8_gemm(a, aa_t[:, 160:256], out, accumulate=accumulate)
    want = _want(a, aa_t[:, 160:256].contiguous(),
                 c0 if accumulate else None)
    assert torch.equal(out.long(), want)


def test_gemm_ops_counts_each_call(rng):
    TD.reset_gemm_ops()
    for m, n, k in SHAPES:
        TD.int8_gemm(_int8(rng, (m, k)), _int8(rng, (n, k)),
                     torch.zeros((m, n), dtype=torch.int32))
    assert TD.gemm_ops == sum(2 * m * n * k for m, n, k in SHAPES)
    TD.reset_gemm_ops()


def test_wrapper_refuses_what_the_kernel_does_not_take(rng):
    """Every device: int8 operands, an int32 output, K contiguous in both
    operands, matching shapes."""
    a, b = _int8(rng, (32, 64)), _int8(rng, (48, 64))
    out = torch.zeros((32, 48), dtype=torch.int32)
    with pytest.raises(TypeError, match="int8 operands"):
        TD.int8_gemm(a.to(torch.int16), b, out)
    with pytest.raises(TypeError, match="int8 operands"):
        TD.int8_gemm(a, b.float(), out)
    with pytest.raises(TypeError, match="writes int32"):
        TD.int8_gemm(a, b, out.long())
    with pytest.raises(ValueError, match="contiguous along K"):
        TD.int8_gemm(a, _int8(rng, (64, 48)).t(), out)   # B K-strided
    with pytest.raises(ValueError, match="contiguous along K"):
        TD.int8_gemm(_int8(rng, (64, 32)).t(), b, out)   # A K-strided
    with pytest.raises(ValueError, match="do not make"):
        TD.int8_gemm(a, b[:, :32], out)
    with pytest.raises(ValueError, match="do not make"):
        TD.int8_gemm(a, b, out[:, :40])
    assert torch.equal(out, torch.zeros_like(out))


def test_card_rules_refuse_unaligned_operands(rng):
    """On CUDA the kernel's TMA copies need 16-byte aligned bases and row
    strides, and output rows of whole 16-byte pieces: a base 8 bytes off
    (a segment start off 16), a row stride of an odd width, an output row
    of 6 int32 (strided or not) are refused; the engine's own shapes at
    the card's sizes pass."""
    a, b = _int8(rng, (32, 64)), _int8(rng, (48, 64))
    out = torch.zeros((32, 48), dtype=torch.int32)
    TD._check_gemm(a, b, out, aligned=True)
    wide = _int8(rng, (48, 512))
    TD._check_gemm(a, wide[:, 160:224], out, aligned=True)
    for bad in ((a, wide[:, 152:216], out),                   # base 8 off
                (_int8(rng, (32, 72))[:, :64], b, out),       # stride 72
                (a, b, torch.zeros((32, 54), dtype=torch.int32)[:, :48]),
                (_int8(rng, (32, 20)), _int8(rng, (6, 20)),
                 torch.zeros((32, 6), dtype=torch.int32)),
                (a, b[:6], torch.zeros((32, 8), dtype=torch.int32)[:, :6])):
        with pytest.raises(ValueError, match="16-byte aligned"):
            TD._check_gemm(*bad, aligned=True)
        TD._check_gemm(*bad, aligned=False)


@pytest.mark.parametrize("s0,sl", [(3, 13), (17, 47), (21, 200), (37, 1),
                                   (130, 155), (250, 6), (300, 212)])
def test_segment_at_128_bytes_equals_the_segment_alone(s0, sl, rng):
    """A class segment starting off 16 (and off 128), cut by
    ``_segment_operand`` (both bases and A's rows on 128-byte boundaries,
    or A ending with the one-hot), through the GEMM against pass 2's
    transposed one-hot, gives the int32 product over the segment alone."""
    mat = _int8(rng, (24, 512))
    aa_t = _int8(rng, (3 * 48, 512), 0, 2)
    op, r0, r1 = TD._segment_operand(mat, s0, sl)
    assert r0 % 128 == 0 and r0 <= s0 and s0 + sl <= r1
    assert (r1 - r0) % 128 == 0 or r1 == mat.shape[1]
    TD._check_gemm(op, aa_t[:, r0:r1], torch.empty(
        (24, 3 * 48), dtype=torch.int32), aligned=True)
    out = torch.empty((24, 3 * 48), dtype=torch.int32)
    TD.int8_gemm(op, aa_t[:, r0:r1], out)
    assert torch.equal(out.long(), _want(mat[:, s0:s0 + sl],
                                         aa_t[:, s0:s0 + sl]))


@pytest.mark.parametrize("bits,s", [(0, 3), (2, 3)])
def test_match_rows_adds_every_window_in_place(bits, s, monkeypatch, rng):
    """Pass 1 builds no product of its own: every window goes through the
    GEMM's accumulating form into the one count matrix it returns, which
    holds the exact match counts."""
    monkeypatch.setattr(TD, "_PASS1_ONEHOT_BYTES", 0)
    n, p, ft = 40, 64, 16
    codes = rng.randint(0, s, (n, p)).astype(np.int8)
    codes_a = torch.from_numpy(codes)
    if bits:
        codes_a = TD._pack_codes(codes_a, s)[0]
    calls = []
    gemm = TD.int8_gemm

    def spy(a, b, out, *, accumulate=False):
        calls.append((out.data_ptr(), accumulate))
        return gemm(a, b, out, accumulate=accumulate)
    monkeypatch.setattr(TD, "int8_gemm", spy)
    got = TD._match_rows(codes_a[:16], codes_a, ft, s, bits)
    assert len(calls) == -(-p // TD.pass1_width(n, s, ft, 16))
    assert calls == [(got.data_ptr(), True)] * len(calls)
    want = (codes[:16, None, :] == codes[None, :, :]).sum(-1)
    assert np.array_equal(got.numpy(), want)


def test_launch_through_the_library(monkeypatch):
    """On CUDA the wrapper launches ``fs_int8_gemm`` with the operands'
    addresses, row strides (bytes of A and B, int32 elements of C), the
    shape and the form, counted in ``launches.int8_gemm``."""
    calls = []

    class Lib:
        def fs_int8_gemm(self, *args):
            calls.append(args)
            return 0

    class Stream:
        cuda_stream = 77

    class Fake:
        """A CUDA-placed 2-d tensor, as far as the wrapper looks."""
        device = torch.device("cuda", 0)

        def __init__(self, dtype, shape, strides, ptr):
            self.dtype, self.shape, self._s, self._p = (dtype,
                                                        torch.Size(shape),
                                                        strides, ptr)

        def dim(self):
            return 2

        def stride(self, i):
            return self._s[i]

        def data_ptr(self):
            return self._p

    monkeypatch.setattr(_build, "load", lambda: Lib())
    monkeypatch.setattr(torch.cuda, "device", lambda dev: _Null())
    monkeypatch.setattr(torch.cuda, "current_stream", lambda dev: Stream())
    monkeypatch.setitem(_build.launches, "int8_gemm", 0)
    a = Fake(torch.int8, (4096, 6144), (6144, 1), 1 << 20)
    b = Fake(torch.int8, (3072, 6144), (32768, 1), 2 << 20)
    out = Fake(torch.int32, (4096, 3072), (3072, 1), 3 << 20)
    TD.reset_gemm_ops()
    TD.int8_gemm(a, b, out, accumulate=True)
    assert calls == [(1 << 20, 6144, 2 << 20, 32768, 3 << 20, 3072, 4096,
                      3072, 6144, 1, 77)]
    assert _build.launches["int8_gemm"] == 1
    assert TD.gemm_ops == 2 * 4096 * 3072 * 6144
    TD.reset_gemm_ops()


def test_gemm_phase_rehearse(monkeypatch):
    """chip_smoke.py's phase 30 at a small size on the CPU: every case's
    operands as the engine cuts them (the segment off 16, the parent's cut
    at 8), its row of timings, and the fit held to the parent's arithmetic
    bit for bit (the twin stands in for the kernel, so nothing launches)."""
    def host_ms(fn, reps, warmup=1):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    monkeypatch.setattr(cs, "cuda_ms", host_ms)
    for name in ("synchronize", "empty_cache"):
        monkeypatch.setattr(torch.cuda, name, lambda *a: None)
    monkeypatch.setattr(TD, "_V2_MIN_N", 1)
    before = dict(_build.launches)
    err, timing, fit = cs.gemm_phase(torch.device("cpu"), cases=(
        ("pass 1", 64, 96, 48, True, "rows"),
        ("pass 2", 64, 48, 21, False, "segment"),
        ("sym", 32, 96, 80, False, "sym"),
        ("ragged", 48, 204, 80, True, "rows")), fit=(300, 500))
    rows = timing["int8_gemm"]
    assert err == {"int8_gemm": 0} and len(rows) == 4
    assert all(row["max_abs_err"] == 0 for row in rows)
    assert all(row["launches_a_fit"] >= 0 for row in rows)
    assert "columns [0, 128), the parent's [16, 48)" in rows[1]["shape"]
    assert rows[1]["library_aligned_ms"] > 0
    assert rows[3]["plain_ms"] is None and rows[3]["library_ms"] is None
    assert all(0 < row["share"] for row in rows)
    assert fit["kernel_s"] > 0 and fit["parent_s"] > 0
    assert _build.launches == before


def test_fit_launches_of_matches_each_case_shape():
    """Phase 30's launches a fit at a case's shape: m, n and accumulate
    alike, and k too, except for a class segment, whose length varies."""
    shapes = {(4096, 32768, 18432, True): 256,
              (4096, 32768, 12288, True): 8,
              (4096, 3072, 15008, False): 1568,
              (4096, 3072, 32768, False): 392,
              (4096, 3072, 17760, False): 1176}
    def case(m, n, k, acc, form):
        return ("case", m, n, k, acc, form)
    assert cs.fit_launches_of(case(4096, 32768, 18432, True, "rows"),
                              shapes) == 256
    assert cs.fit_launches_of(case(4096, 32768, 6144, True, "rows"),
                              shapes) == 0
    assert cs.fit_launches_of(case(4096, 3072, 15003, False, "segment"),
                              shapes) == 3136
    assert cs.fit_launches_of(case(4096, 3072, 15003, True, "segment"),
                              shapes) == 0
    assert cs.fit_launches_of(case(4096, 12288, 196608, False, "sym"),
                              shapes) == 0


class _Null:
    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False


def _card():
    """The first CUDA device; the calling test skips without one."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda", 0)


@pytest.mark.card
@pytest.mark.parametrize("accumulate", [False, True])
@pytest.mark.parametrize("m,n,k", [(16, 48, 32), (48, 200, 80),
                                   (40, 204, 144),
                                   (300, 520, 1000), (4096, 3072, 2048)])
def test_kernel_equals_int_mm_on_the_card(m, n, k, accumulate):
    """The kernel, bit for bit, on ragged shapes and a strided B, into an
    output whose rows lie further apart than its width, which it leaves
    as it was past its width."""
    card = _card()
    g = torch.Generator(device=card).manual_seed(m * n + k)
    kp = -(-k // 16) * 16
    a = torch.randint(-1, 2, (m, kp), dtype=torch.int8, device=card,
                      generator=g)[:, :k]
    b = torch.randint(-1, 2, (n, kp + 32), dtype=torch.int8, device=card,
                      generator=g)[:, 16:16 + k]
    wide = torch.randint(-99, 99, (m, -(-n // 4) * 4 + 4), device=card,
                         dtype=torch.int32, generator=g)
    out = wide[:, :n]
    c0, tail = out.clone(), wide[:, n:].clone()
    TD.int8_gemm(a, b, out, accumulate=accumulate)
    want = (a.double() @ b.double().t()).int()
    assert torch.equal(out, want + c0 if accumulate else want)
    assert torch.equal(wide[:, n:], tail)


@pytest.mark.card
def test_kernel_refuses_unaligned_operands_on_the_card():
    card = _card()
    a = torch.zeros((32, 64), dtype=torch.int8, device=card)
    b = torch.zeros((48, 80), dtype=torch.int8, device=card)
    out = torch.zeros((32, 48), dtype=torch.int32, device=card)
    before = dict(_build.launches)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TD.int8_gemm(a, b[:, 8:72], out)
    with pytest.raises(ValueError, match="16-byte aligned"):
        TD.int8_gemm(a, b[:6, :64], out[:, :6])
    assert _build.launches == before


@pytest.mark.card
@pytest.mark.parametrize("engine", ["discrete", "hybrid"])
def test_classes_under_32_rows_on_the_card(engine, monkeypatch):
    """Classes of 7 and 13 rows, class-sorted: focal blocks and class
    rows padded to 16 on the card, so the kernel's A has 16 rows.  The
    discrete scores (exact integer distances) equal the CPU's up to
    float32 sums in another order; the hybrid's, whose float distances
    come from the card's kernels, within the fit tolerance that
    chip_smoke.py holds the card's hybrid fits to."""
    card = _card()
    from fastselect_tpu_torch.ops import relief_hybrid as TH
    monkeypatch.setattr(TD, "_V2_MIN_N", 16)
    rng = np.random.RandomState(23)
    n = 20 if engine == "discrete" else 300
    y = np.array([0] * 7 + [1] * 13 + [2] * (n - 20), np.int32)[
        rng.permutation(n)]
    cp = np.bincount(y).astype(np.float32) / n
    x = rng.rand(n, 96).astype(np.float32)
    disc = np.zeros(96, bool)
    disc[:40] = True
    x[:, :40] = rng.randint(0, 3, (n, 40))
    recip = (1.0 / np.maximum(x.max(0) - x.min(0), 1e-9)).astype(np.float32)
    kw = dict(algo="multisurf", use_star=True, class_probs=cp)
    before = _build.launches["int8_gemm"]
    if engine == "discrete":
        codes = x[:, :40].astype(np.int8)
        got = TD.relief_discrete_scores(
            None, y, codes=torch.from_numpy(codes).to(card), n_states=3,
            **kw)
        want = TD.relief_discrete_scores(None, y, codes=codes, n_states=3,
                                         **kw)
    else:
        got = TH.relief_hybrid_scores(torch.from_numpy(x).to(card), y,
                                      recip, disc, **kw)
        want = TH.relief_hybrid_scores(x, y, recip, disc, **kw)
    assert _build.launches["int8_gemm"] > before
    got, want = np.asarray(got), np.asarray(want)
    if engine == "discrete":
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=2e-7)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=cs.fit_tol(want))
