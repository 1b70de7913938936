"""ReliefF's weight rule (one stable sort of each row) on the CPU.

The JAX package has two ReliefF rules: by default a ``top_k`` of each
rule's masked row (C + 1 sorts), and under ``FS_RELIEFF_ARGSORT=1`` one
argsort shared by every rule.  The port has one rule, the shared sort.
It is held to JAX's argsort rule on the same D (masks equal,
coefficients bit for bit) and, through the weights it sums to, to JAX's
default rule (bit for bit: the JAX docstring's claim, also checked
between JAX's own two rules).  ReliefF fits through every engine of the
port equal, bit for bit, the fits in which a plain C + 1-sort rule
(``_rules_c_plus_1_sorts`` below, the port's earlier rule) takes its
place, whatever ``FS_RELIEFF_ARGSORT`` says, and lie within
``tests/test_torch_surf_relieff.py``'s rtol 1e-4, atol 1e-5 of JAX's
fits with the variable set, with equal rankings.

JAX reads the variable while it traces: its comparisons call the rule
directly, or clear JAX's caches around the switch.
"""

from functools import partial

import jax
import numpy as np
import pytest
import torch
from numpy.testing import assert_allclose, assert_array_equal

import chip_smoke as cs
import fastselect_tpu
import fastselect_tpu.ops.relief_discrete as JD
import fastselect_tpu_torch
import fastselect_tpu_torch.ops.relief_cuda as RC
import fastselect_tpu_torch.ops.relief_discrete as TD
import fastselect_tpu_torch.ops.relief_hybrid as TH
from fastselect_tpu.ops import relief as JR
from fastselect_tpu_torch.ops import relief as TR
from test_torch_chip_mesh import cpu_card  # noqa: F401  (a fixture)
from test_torch_parallel import _same_ranking

torch.set_num_threads(2)

ENV = "FS_RELIEFF_ARGSORT"
N_REAL, N_PAD, T = 37, 48, 16
BLOCKS = {"inner": 16, "padded": 32}   # rows 37..47 of "padded" are padding


@pytest.fixture
def default_rule(monkeypatch):
    monkeypatch.delenv(ENV, raising=False)


def _topk_weight_rows(D_masked, k, n_pad):
    """One-hot weight rows for the k smallest entries of each masked row,
    ties to the lower index, as ``lax.top_k`` picks them."""
    vals, idx = torch.sort(D_masked, dim=1, stable=True)
    vals, idx = vals[:, :k], idx[:, :k]
    sel = (vals < TR._INF / 2).to(torch.float32)
    W = torch.zeros((D_masked.shape[0], n_pad), dtype=torch.float32)
    W.scatter_(1, idx, sel)
    return W, sel.sum(dim=1)


def _rules_c_plus_1_sorts(D, yi, vi, iid, y_flat, valid_flat, k,
                          class_probs):
    """The plain referee: JAX's default ReliefF rule in torch, one stable
    sort of each rule's masked row (the hits, then each class)."""
    n_pad, n_classes = D.shape[1], class_probs.shape[0]
    vmask, hit = TR._pair_masks(D, yi, vi, iid, y_flat, valid_flat)
    W_hit, h_found = _topk_weight_rows(torch.where(hit & vmask, D, TR._INF),
                                       k, n_pad)
    hit_norm = torch.where(h_found > 0,
                           1.0 / torch.clamp_min(h_found, 1.0), 0.0)
    rules = [(W_hit > 0, -hit_norm)]
    denom = 1.0 - class_probs[yi.clamp(max=n_classes - 1)]
    denom = torch.where(denom == 0, 1.0, denom)
    for c in range(n_classes):
        cand = (y_flat[None, :] == c) & vmask & (yi != c)[:, None]
        W_c, _ = _topk_weight_rows(torch.where(cand, D, TR._INF), k, n_pad)
        w_c = (class_probs[c] / denom) * (np.float32(1) / np.float32(k))
        rules.append((W_c > 0, w_c.expand_as(hit_norm)))
    return rules


@partial(jax.jit, static_argnums=(6,))
def _jax_argsort(D, yi, vi, iid, y, valid, k, cp):
    return JR._rules_relieff_argsort(D, yi, vi, iid, y, valid, k, cp)


@partial(jax.jit, static_argnums=(6,))
def _jax_w_argsort(D, yi, vi, iid, y, valid, k, cp):
    return JR._sum_rules(JR._rules_relieff_argsort(D, yi, vi, iid, y, valid,
                                                   k, cp))


@partial(jax.jit, static_argnums=(6,))
def _jax_w_default(D, yi, vi, iid, y, valid, k, cp):
    # traced only with the variable unset (the default_rule fixture)
    return JR._sum_rules(JR._rules_relieff(D, yi, vi, iid, y, valid, k, cp))


def _distances(rng, kind):
    if kind == "integer":                  # ties everywhere
        return rng.randint(0, 6, (T, N_PAD)).astype(np.float32)
    if kind == "quantised":                # ties between non-integers
        return (rng.randint(0, 12, (T, N_PAD)) / 4).astype(np.float32)
    return (rng.rand(T, N_PAD) * 5).astype(np.float32)


def _block(rng, ncls, kind, block):
    """One focal block of T rows from global row ``BLOCKS[block]``, with
    padded samples (label -1, validity 0) past N_REAL."""
    D = _distances(rng, kind)
    y = np.full(N_PAD, -1, np.int32)
    y[:N_REAL] = rng.randint(0, ncls, N_REAL)
    valid = (y >= 0).astype(np.float32)
    rows = np.arange(BLOCKS[block], BLOCKS[block] + T)
    cp = np.bincount(y[:N_REAL], minlength=ncls).astype(np.float32) / N_REAL
    return D, y[rows], valid[rows], rows.astype(np.int32), y, valid, cp


def _torch_args(D, yi, vi, iid, y, valid, cp):
    t = torch.from_numpy
    return (t(D), t(yi).long(), t(vi), t(iid).long(), t(y).long(), t(valid),
            t(cp))


def _port(rule, args, k):
    D, yi, vi, iid, y, valid, cp = _torch_args(*args)
    return rule(D, yi, vi, iid, y, valid, k, cp)


def _bits(a):
    return np.asarray(a, np.float32).view(np.int32)


GRID = [(ncls, k, kind, block)
        for ncls in (2, 3) for k in (3, 30)       # 30: past a class's count
        for kind in ("integer", "quantised", "float")
        for block in BLOCKS]


@pytest.mark.parametrize("ncls,k,kind,block", GRID)
def test_rule_matches_jax(ncls, k, kind, block, rng):
    args = _block(rng, ncls, kind, block)
    ref = _jax_argsort(*args[:6], k, args[6])
    got = _port(TR._rules_relieff, args, k)
    assert len(got) == len(ref) == ncls + 1
    for (m, r), (jm, jr) in zip(got, ref):
        assert m.dtype == torch.bool and r.dtype == torch.float32
        assert_array_equal(m.numpy(), np.asarray(jm))
        assert_array_equal(_bits(r.numpy()), _bits(jr))
    if block == "padded":
        assert not any(m[N_REAL - 32:].any() for m, _ in got)


@pytest.mark.parametrize("ncls,k,kind,block", GRID)
def test_weights_equal_the_default_rule(ncls, k, kind, block, default_rule,
                                        rng):
    """W from one sort equals W from the C + 1 sorts bit for bit: the
    port's against JAX's two rules and the plain referee, and JAX's two
    rules against each other."""
    args = _block(rng, ncls, kind, block)
    w = TR._sum_rules(_port(TR._rules_relieff, args, k))
    assert_array_equal(_bits(w), _bits(TR._sum_rules(
        _port(_rules_c_plus_1_sorts, args, k))))
    jax_argsort = _jax_w_argsort(*args[:6], k, args[6])
    assert_array_equal(_bits(jax_argsort),
                       _bits(_jax_w_default(*args[:6], k, args[6])))
    assert_array_equal(_bits(w), _bits(jax_argsort))


@pytest.mark.parametrize("kind", ["integer", "quantised", "float"])
@pytest.mark.parametrize("block", list(BLOCKS))
def test_labels_past_class_probs(kind, block, default_rule, rng):
    """With the op-level default of one dummy class (probability 0) and
    three labels, the hits are still each row's own label, as in JAX's
    default rule (its argsort rule finds none past class_probs)."""
    D, yi, vi, iid, y, valid, _ = _block(rng, 3, kind, block)
    cp = np.zeros(1, np.float32)
    args = (D, yi, vi, iid, y, valid, cp)
    w = TR._sum_rules(_port(TR._rules_relieff, args, 3))
    assert_array_equal(_bits(w), _bits(_jax_w_default(*args[:6], 3, cp)))
    past = (yi >= 1) & (vi > 0)        # labels past the one class
    assert past.any() and (w.numpy()[past] < 0).any(axis=1).all()


@pytest.mark.parametrize("value", ["1", "0", "", "true", None])
def test_switch_has_no_effect(value, monkeypatch, rng):
    """The port reads no FS_RELIEFF_ARGSORT: every value gives the same
    masks and coefficients, and the same focal blocks, which set the
    order of the score sums."""
    args = _block(rng, 2, "integer", "inner")
    monkeypatch.setattr(RC, "_CPU_BLOCK_BYTES", 64 * 50048 * 64 * 46)
    got = []
    for env in (value, None):
        if env is None:
            monkeypatch.delenv(ENV, raising=False)
        else:
            monkeypatch.setenv(ENV, env)
        D, yi, vi, iid, y, valid, cp = _torch_args(*args)
        got.append((TR.pair_weight_rules(D, yi, vi, iid, y, valid, None, cp,
                                         algo="relieff", use_star=False,
                                         k=3),
                    RC.block_plan(50000, 100, torch.device("cpu"),
                                  "relieff")))
    (rules, plan), (rules0, plan0) = got
    for (m, r), (m0, r0) in zip(rules, rules0, strict=True):
        assert torch.equal(m, m0) and torch.equal(r, r0)
    assert plan == plan0 and plan.nb == 2944


# ---------------------------------------------------------------------------
# ReliefF fits through every engine
# ---------------------------------------------------------------------------

def _continuous(rng, ncls, n=120, p=20):
    """Continuous columns on a grid of 1/1024 steps with both ends in
    every column (recip 1): every distance is exact in float32, in either
    package's order of summation."""
    y = rng.randint(0, ncls, n)
    X = rng.randint(0, 1025, (n, p)) / 1024
    X[0], X[1] = 0.0, 1.0
    X[:, 4] = (128 * y + rng.randint(0, 769, n)) / 1024
    return X, y


def _codes(rng, ncls):
    """tests/test_torch_relief_discrete.py's genotypes, as int8 codes."""
    y = rng.randint(0, ncls, 230)
    X = rng.randint(0, 3, (230, 37))
    X[:, 0] = y % 3
    return X.astype(np.int8), y


def _mixed(rng, ncls, n=120):
    X, y = _continuous(rng, ncls, n)
    X[:, :6] = rng.randint(0, 3, (n, 6))
    X[:, 0] = y % 3
    return X, y


def _mixed_wide(rng, ncls):
    """A 150-state discrete column (discrete_limit 160): past int8 state
    codes, so the fused engine's MIXED passes."""
    X, y = _mixed(rng, ncls, 240)
    X[:, 1] = np.arange(240) % 150
    return X, y


def _mesh(monkeypatch):
    monkeypatch.setattr(TR, "_AUTO_SHARD_MIN_ELEMS", 1000)
    monkeypatch.setattr(TR, "_mesh_devices",
                        lambda device: [] if device is None
                        else [torch.device("cpu")] * 2)


def _force(monkeypatch, gates):
    if "v2" in gates:
        for mod in (JD, TD):
            monkeypatch.setattr(mod, "_V2_MIN_N", 1)
    if "blocked" in gates:
        monkeypatch.setattr(TH, "HYBRID_SQUARE_MAX_N", 64)
        monkeypatch.setattr(RC, "_CPU_BLOCK_BYTES", 64 * 128 * 80)
    if "mesh" in gates:
        _mesh(monkeypatch)


# case -> (data, port engine, gates forced, estimator parameters)
K5, K4 = {"n_neighbors": 5}, {"n_neighbors": 4}
CASES = {
    "fused": (_continuous, "fused", (), K5),
    "fused-blocks": (_continuous, "fused", ("blocked",), K5),
    "fused-mixed": (_mixed_wide, "fused", (),
                    {"n_neighbors": 5, "discrete_limit": 160}),
    "discrete-v1": (_codes, "discrete", (), K4),
    "discrete-v2": (_codes, "discrete", ("v2",), K4),
    "hybrid-square": (_mixed, "hybrid", (), K5),
    "hybrid-blocked": (_mixed, "hybrid", ("blocked",), K5),
    "mesh-continuous": (_continuous, "fused", ("mesh",), K5),
    "mesh-discrete": (_codes, "discrete", ("mesh",), K4),
}


def _fit(monkeypatch, value, X, y, params, package=fastselect_tpu_torch):
    if value is None:
        monkeypatch.delenv(ENV, raising=False)
    else:
        monkeypatch.setenv(ENV, value)
    return package.ReliefF(n_features_to_select=5, backend="cpu",
                           **params).fit(X, y)


def _case(monkeypatch, rng, case, ncls):
    make, engine, gates, params = CASES[case]
    _force(monkeypatch, gates)
    X, y = make(rng, ncls)
    return X, y, params, engine, gates


@pytest.mark.parametrize("ncls", [2, 3])
@pytest.mark.parametrize("case", list(CASES))
def test_fit_equals_c_plus_1_sorts_fit(case, ncls, monkeypatch, rng):
    """The port's fit under FS_RELIEFF_ARGSORT=1 equals, bit for bit, its
    fit with the variable unset and the plain C + 1-sort rule in the
    rule's place."""
    X, y, params, engine, gates = _case(monkeypatch, rng, case, ncls)
    calls = []
    with monkeypatch.context() as m:
        m.setattr(TR, "_rules_relieff",
                  lambda *a: calls.append(1) or _rules_c_plus_1_sorts(*a))
        default = _fit(monkeypatch, None, X, y, params)
    assert calls, "the referee rule ran"
    est = _fit(monkeypatch, "1", X, y, params)
    states = max((len(np.unique(c)) for c in X.T[est.is_discrete_]),
                 default=0)
    assert TR.relief_engine(X.shape[0], est.is_discrete_, states) == engine
    if {"blocked", "mesh"} & set(gates):
        assert len(calls) > 1           # several focal blocks, or shards
    assert_array_equal(_bits(est.feature_importances_),
                       _bits(default.feature_importances_))
    assert_array_equal(est.top_features_, default.top_features_)


@pytest.mark.parametrize("ncls", [2, 3])
@pytest.mark.parametrize("case", ["fused", "fused-mixed", "discrete-v1",
                                  "discrete-v2", "hybrid-square",
                                  "hybrid-blocked"])
def test_fit_matches_jax_with_the_switch(case, ncls, monkeypatch, rng):
    X, y, params, _, _ = _case(monkeypatch, rng, case, ncls)
    got = _fit(monkeypatch, "1", X, y, params)
    traced = []
    orig = JR._rules_relieff_argsort
    monkeypatch.setattr(JR, "_rules_relieff_argsort",
                        lambda *a: traced.append(1) or orig(*a))
    jax.clear_caches()
    try:
        ref = _fit(monkeypatch, "1", X, y, params, package=fastselect_tpu)
    finally:
        jax.clear_caches()
    assert traced, "JAX traced its argsort rule"
    assert_allclose(got.feature_importances_, ref.feature_importances_,
                    rtol=1e-4, atol=1e-5)
    _same_ranking(got.feature_importances_, ref.feature_importances_)
    assert_array_equal(got.top_features_, ref.top_features_)


def test_chip_phase_26_rehearses(monkeypatch, cpu_card, tmp_path):
    """chip_smoke.py's phase 26 at a small size on the CPU: the rule on
    the three inputs (large-n and v1 held to their own earlier fits), the
    drop-in fit and the example."""
    monkeypatch.setattr(torch.cuda, "memory_allocated", lambda *a: 0)
    fused = RC.relief_fused_scores              # its passes, counted
    monkeypatch.setattr(RC, "relief_fused_scores", lambda *a, **k: fused(
        *a, _pass1=RC.dist_matrix, _pass2=RC.accumulate, **k))
    monkeypatch.setattr(cs, "BUILD_DIR", tmp_path)
    monkeypatch.setattr(cs, "JAX_PACKAGES", ())  # this process holds JAX
    monkeypatch.delenv(ENV, raising=False)
    cpu = torch.device("cpu")
    X_n, y_n = cs.make_classification(n_samples=300, n_features=40,
                                      n_informative=10, random_state=0)
    X_n = X_n.astype(np.float32)
    X_mf = X_n.copy()
    X_mf[:, :10] = np.random.RandomState(3).randint(0, 3, (300, 10))
    X_mf[:, 0] = 2 * y_n
    X_mf[:, 1] = np.arange(300) % 150            # 150 states
    scores_n = fastselect_tpu_torch.MultiSURF(
        n_features_to_select=10).fit(X_n, y_n).feature_importances_
    X_v1, y_v1 = cs.planted_genotypes(1, 300, 200, 3)
    refs = {"large-n": fastselect_tpu_torch.ReliefF(
                n_features_to_select=10, n_neighbors=10).fit(
                    X_n, y_n).feature_importances_,
            "tier-v1": fastselect_tpu_torch.ReliefF(
                n_features_to_select=3, n_neighbors=5).fit(
                    X_v1, y_v1).feature_importances_}
    res, launches = cs.completeness_phase(cpu, X_n, y_n, X_mf, y_n,
                                          scores_n, refs,
                                          v1_shape=(300, 200),
                                          example=(260, 180))
    assert all(launches[name] > 0 for name in cs.KERNELS)
    for label in ("large-n", "tier-v1", "mixed-fused"):
        assert len(res[label]["warm_s"]) == 2
        assert res[label]["peak_gb"] == 0
    assert res["example_s"] > 0
    trace = tmp_path / "trace-relieff-large-n" / "trace.json"
    assert trace.is_file()


def test_trace_device_time_by_range(tmp_path):
    """chip_smoke.trace_device_s: device events count to a range when the
    runtime call that launched them starts inside it."""
    def ev(cat, ts, dur, name="k", corr=None):
        e = {"cat": cat, "name": name, "ts": ts, "dur": dur, "args": {}}
        if corr is not None:
            e["args"]["correlation"] = corr
        return e
    trace = {"traceEvents": [
        ev("user_annotation", 100, 50, cs.RULES_RANGE),
        ev("gpu_user_annotation", 120, 400, cs.RULES_RANGE),
        ev("cuda_runtime", 110, 2, corr=1), ev("kernel", 130, 30, corr=1),
        ev("cuda_runtime", 140, 2, corr=2), ev("gpu_memset", 170, 5, corr=2),
        ev("cuda_runtime", 160, 2, corr=3), ev("kernel", 180, 70, corr=3),
        ev("cuda_driver", 149, 1, corr=4), ev("kernel", 250, 11, corr=4),
        ev("gpu_memcpy", 300, 100)]}
    path = tmp_path / "trace.json"
    path.write_text(cs.json.dumps(trace))
    inside, total = cs.trace_device_s(path, cs.RULES_RANGE)
    assert inside == pytest.approx(46e-6) and total == pytest.approx(216e-6)
