"""The port's span tree, counters and records (``utils/logging.py``) on
the CPU: nothing at all below INFO; at INFO a tree of parented spans,
one record per name with counter deltas on the root's, records that the
benchmark's reader parses, and the tree nested in a profiler trace."""

import ast
import json
import logging
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from fastselect_tpu_torch import MultiSURF, ReliefF
from fastselect_tpu_torch import _build
from fastselect_tpu_torch.models import _relief_base as TB
from fastselect_tpu_torch.ops import relief_cuda as rc
from fastselect_tpu_torch.ops import relief_discrete as rd
from fastselect_tpu_torch.utils import logging as fs_logging
from fastselect_tpu_torch.utils import profiling
from portbench.tracing import _RECORD

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
LOGGER = "fastselect_tpu_torch"
# prefixes that the benchmark's readers and chip_smoke.py's PhaseRecords
# sum by: a new span under one of them would be counted twice
READ_PREFIXES = ("relief_cuda.engine", "relief_discrete.", "staging.",
                 "ring.")
# the staging steps' spans keep the names their records always had
STAGING_SPANS = {"staging.cast", "staging.h2d", "staging.analysis"}
FIT_SPANS = ["fit.validate", "fit.analysis", "fit.score", "fit.select"]


@pytest.fixture
def info_log(caplog):
    caplog.set_level(logging.INFO, logger=LOGGER)
    return caplog


def _fits(rng, monkeypatch):
    """A fused fit of host X, a discrete v2 fit of int8 codes and a staged
    fit, each small enough for the CPU."""
    monkeypatch.setattr(rd, "_V2_MIN_N", 16)
    monkeypatch.setattr(TB, "_STAGED_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(TB, "_STAGED_MIN_ELEMS", 1000)
    y = rng.randint(0, 2, 60)
    MultiSURF(backend="cpu").fit(rng.rand(60, 12), y)
    ReliefF(backend="cpu", n_neighbors=3).fit(
        rng.randint(0, 3, (60, 24)).astype(np.int8), y)
    MultiSURF(backend="cpu").fit(rng.rand(60, 40), y)


def _spans(records):
    """name -> [(id, parent, start ns, host s, s)] over ``records``."""
    out = {}
    for r in records:
        for sp in getattr(r, "spans", ()):
            out.setdefault(r.getMessage().split(":")[0], []).append(sp)
    return out


# ---------------------------------------------------------------------------
# Off: below INFO nothing happens
# ---------------------------------------------------------------------------

def test_below_info_no_event_range_sync_or_record(monkeypatch, caplog, rng):
    caplog.set_level(logging.WARNING, logger=LOGGER)
    calls = []

    def spy(what):
        def record(*a, **k):
            calls.append(what)
            raise AssertionError(f"{what} below INFO")
        return record
    monkeypatch.setattr(torch.cuda, "Event", spy("torch.cuda.Event"))
    monkeypatch.setattr(torch.profiler, "record_function",
                        spy("record_function"))
    monkeypatch.setattr(fs_logging, "_synchronize", spy("_synchronize"))
    monkeypatch.setattr(fs_logging, "_snapshot", spy("_snapshot"))
    before = dict(fs_logging._counts)
    _fits(rng, monkeypatch)
    with fs_logging.span("weight_rules", device=torch.device("cuda", 0)):
        fs_logging.count("windows", 3)
    assert calls == [] and caplog.records == []
    assert fs_logging._counts == before
    assert getattr(fs_logging._stack, "spans", []) == []


def test_below_info_a_span_is_one_shared_object(caplog):
    """No allocation: every span and phase is the same no-op."""
    caplog.set_level(logging.WARNING, logger=LOGGER)
    before = dict(fs_logging._counts)
    assert fs_logging.span("a") is fs_logging.span("b", device=True) \
        is fs_logging.phase("c", work=1.0) is fs_logging._OFF
    fs_logging.count("h2d_chunks", 5)
    assert fs_logging._counts == before


# ---------------------------------------------------------------------------
# On: the tree, its records and its counters
# ---------------------------------------------------------------------------

def test_fit_tree_parents_and_start_order(info_log, rng):
    X, y = rng.rand(60, 12), rng.randint(0, 2, 60)
    MultiSURF(backend="cpu").fit(X, y)
    spans = _spans(info_log.records)
    (root,) = spans["fit[MultiSURF]"]
    assert root[1] == 0                                   # a root
    steps = [spans[name] for name in FIT_SPANS]
    assert all(len(s) == 1 and s[0][1] == root[0] for s in steps)
    starts = [s[0][2] for s in steps]
    assert starts == sorted(starts) and starts[0] >= root[2]
    score = spans["fit.score"][0]
    (engine,) = spans["relief_cuda.engine[multisurf]"]
    assert spans["fused.plan"][0][1] == score[0] and engine[1] == score[0]
    assert spans["fused.plan"][0][2] < engine[2]
    for name in ("fused.pass1", "weight_rules", "fused.pass2"):
        assert [sp[1] for sp in spans[name]] == [engine[0]] * len(
            spans[name])
    per_block = zip(spans["fused.pass1"], spans["weight_rules"],
                    spans["fused.pass2"])
    for p1, rules, p2 in per_block:
        assert engine[2] <= p1[2] <= rules[2] <= p2[2]
    # the four steps hold the fit's host time but for a few calls
    assert sum(s[0][3] for s in steps) <= root[3]
    ids = [sp[0] for sps in spans.values() for sp in sps]
    assert len(ids) == len(set(ids))


def test_one_record_per_name_with_counts_and_deltas(info_log, monkeypatch,
                                                    rng):
    monkeypatch.setattr(rd, "_V2_MIN_N", 16)
    y = rng.randint(0, 2, 60)
    mine = {"k1": 0}
    monkeypatch.setattr(fs_logging, "_sources",
                        fs_logging._sources + [("mine", mine)])
    mine["k1"] = 7                       # before the fit: not a delta
    codes = rng.randint(0, 3, (60, 300)).astype(np.int8)
    with monkeypatch.context() as m:
        m.setattr(rd, "_discrete_tile_sizes", lambda n, p, s: (16, 128))
        MultiSURF(backend="cpu").fit(codes, y)
    records = info_log.records
    names = [r.getMessage().split(":")[0] for r in records]
    assert len(names) == len(set(names))
    for r in records:
        m = _RECORD.match(r.getMessage())
        assert m, r.getMessage()
        if "n=" in r.getMessage():
            n = int(r.getMessage().split("n=")[1].split()[0])
            assert n == len(r.spans)
            assert float(m.group(2)) == pytest.approx(
                sum(sp[4] for sp in r.spans), abs=1e-6)
    root = records[names.index("fit[MultiSURF]")]
    blocks = 64 // 16        # 60 rows in blocks of 16
    assert root.counts["focal_blocks"] == blocks
    assert root.counts["windows"] == blocks * 3   # 384 features / 128
    assert "mine.k1" not in root.counts
    # 60 rows padded to 64: the engine adds its padded rows after its blocks
    assert root.counts["padded_rows"] == 4
    assert root.getMessage().endswith(
        f" focal_blocks={blocks} windows={blocks * 3} padded_rows=4")
    assert not any(hasattr(r, "counts") for r in records if r is not root)
    spans = _spans(records)
    assert len(spans["discrete.pass2"]) == blocks
    assert len(spans["weight_rules"]) == blocks


def test_rule_stats_span_and_pass1_ranges(info_log, monkeypatch, rng):
    """A MultiSURF fit of p >> n in three focal blocks: one
    ``weight_rules.stats`` span inside each block's ``weight_rules``, and
    the root's ``pass1_ranges`` adds up pass 1's feature ranges over the
    blocks (4 a block here)."""
    monkeypatch.setattr(rc, "_CPU_BLOCK_BYTES",
                        rc._THRESHOLD_BLOCK_RULE * 192 * rc.TILE_ROWS)
    n, p = 150, 600
    MultiSURF(backend="cpu").fit(rng.rand(n, p), rng.randint(0, 2, n))
    plan = rc.block_plan(n, p, torch.device("cpu"))
    blocks = range(0, plan.n_pad, plan.nb)
    ranges = sum(len(rc.pass1_splits(min(plan.nb, plan.n_pad - b0),
                                     plan.n_pad, plan.p_pad))
                 for b0 in blocks)
    assert len(blocks) == 3 and ranges == 12
    names = [r.getMessage().split(":")[0] for r in info_log.records]
    root = info_log.records[names.index("fit[MultiSURF]")]
    assert root.counts["pass1_ranges"] == ranges
    # the chain ran on the CPU: no rule kernel
    assert "launches.threshold_stats" not in root.counts
    assert "launches.threshold_weights" not in root.counts
    spans = _spans(info_log.records)
    rules = [sp[0] for sp in spans["weight_rules"]]
    assert [sp[1] for sp in spans["weight_rules.stats"]] == rules
    assert len(rules) == len(blocks)


@pytest.mark.card
def test_card_fit_counts_the_rule_launches(info_log, monkeypatch):
    """A MultiSURF fit of a CUDA tensor in three focal blocks launches each
    kernel of ``csrc/threshold_rule.cu`` once a block, counted on the
    root, with one ``weight_rules.stats`` span inside each block's
    ``weight_rules``."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    card = torch.device("cuda", 0)
    rng = np.random.RandomState(0)
    n, p = 150, 600
    monkeypatch.setattr(rc, "_block_budget_bytes", lambda *a, **k:
                        rc._THRESHOLD_BLOCK_RULE * 192 * rc.TILE_ROWS)
    assert rc.block_plan(n, p, card).nb == rc.TILE_ROWS
    X = torch.from_numpy(rng.rand(n, p).astype(np.float32)).to(card)
    MultiSURF().fit(X, rng.randint(0, 2, n))
    names = [r.getMessage().split(":")[0] for r in info_log.records]
    root = info_log.records[names.index("fit[MultiSURF]")]
    assert root.counts["focal_blocks"] == 3
    assert root.counts["launches.threshold_stats"] == 3
    assert root.counts["launches.threshold_weights"] == 3
    spans = _spans(info_log.records)
    rules = [sp[0] for sp in spans["weight_rules"]]
    assert [sp[1] for sp in spans["weight_rules.stats"]] == rules
    assert len(rules) == 3


def test_registered_counter_deltas(info_log, monkeypatch, rng):
    mine = {"k1": 3}
    monkeypatch.setattr(fs_logging, "_sources", [("mine", mine)])
    with fs_logging.span("root"):
        mine["k1"] += 2
        fs_logging.count("windows", 4)
    (rec,) = info_log.records
    assert rec.counts == {"windows": 4, "mine.k1": 2}
    assert rec.getMessage().endswith("n=1 windows=4 mine.k1=2")


def test_staging_counters_and_records(info_log, monkeypatch, rng):
    """A staged fit's root carries the staging counters; the staging
    records keep their names and order, logged before the sweep's phase."""
    monkeypatch.setattr(TB, "_STAGED_DEVICE_TYPES", ("cuda", "cpu"))
    monkeypatch.setattr(TB, "_STAGED_MIN_ELEMS", 1000)
    X, y = rng.rand(60, 40), rng.randint(0, 2, 60)
    MultiSURF(backend="cpu").fit(X, y)
    names = [r.getMessage().split(":")[0] for r in info_log.records]
    i = names.index("staging.analyze")
    assert names[i - 3:i + 1] == ["staging.cast", "staging.h2d",
                                  "staging.analysis", "staging.analyze"]
    root = info_log.records[names.index("fit[MultiSURF]")]
    chunks = root.counts["h2d_chunks"]
    assert chunks >= 1 and root.counts["h2d_bytes"] == X.size * 4
    assert "pinned_allocs" not in root.counts       # no pinning on the CPU
    spans = _spans(info_log.records)
    (analysis,) = spans["fit.analysis"]
    (phase,) = spans["staging.analyze"]
    assert phase[1] == analysis[0]
    assert {sp[1] for sp in spans["staging.cast"]} == {phase[0]}
    assert len(spans["staging.h2d"]) == chunks


def test_device_spans_read_their_events_once_at_the_root(info_log,
                                                         monkeypatch):
    """A span on a CUDA device records an event pair on the device's
    current stream and synchronises nothing until the root closes; then
    it waits once for the last event of each stream."""
    log = []

    class Event:
        made = 0

        def __init__(self, enable_timing=False):
            assert enable_timing
            Event.made += 1
            self.i = Event.made

        def record(self, stream):
            log.append(("record", self.i, stream))

        def synchronize(self):
            log.append(("sync", self.i))

        def elapsed_time(self, end):
            return 250.0 * (end.i - self.i)

    monkeypatch.setattr(torch.cuda, "Event", Event)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: f"stream{dev.index}")
    monkeypatch.setattr(fs_logging, "_synchronize",
                        lambda: pytest.fail("a span synchronised"))
    card, other = torch.device("cuda", 1), torch.device("cuda", 2)
    with fs_logging.span("root"):
        for _ in range(2):
            with fs_logging.span("discrete.pass1", device=card):
                pass
        with fs_logging.span("staging.h2d", device=other):
            pass
        assert all(e[0] == "record" for e in log)
        assert [e[2] for e in log] == ["stream1"] * 4 + ["stream2"] * 2
    assert [e for e in log if e[0] == "sync"] == [("sync", 4), ("sync", 6)]
    rec = {r.getMessage().split(":")[0]: r for r in info_log.records}
    assert rec["discrete.pass1"].getMessage().startswith(
        "discrete.pass1: 0.500000s n=2")


def test_phase_holds_its_spans_and_logs_after_them(info_log, monkeypatch):
    syncs = []
    monkeypatch.setattr(fs_logging, "_synchronize", lambda: syncs.append(1))
    with fs_logging.span("root"):
        with fs_logging.phase("relief_cuda.engine[x]", work=10.0):
            with fs_logging.span("weight_rules"):
                pass
        with fs_logging.span("fit.select"):
            pass
    names = [r.getMessage().split(":")[0] for r in info_log.records]
    assert names == ["weight_rules", "relief_cuda.engine[x]", "root",
                     "fit.select"]
    assert len(syncs) == 2
    phase = info_log.records[1]
    assert "work/s" in phase.getMessage() and "n=" not in phase.getMessage()


def test_a_failed_fit_logs_nothing_and_leaves_no_open_span(info_log, rng):
    X, y = rng.rand(40, 8), rng.randint(0, 2, 40)
    X[3, 2] = np.nan
    with pytest.raises(ValueError):
        MultiSURF(backend="cpu").fit(X, y)
    assert info_log.records == []
    assert fs_logging._stack.spans == []
    X[3, 2] = 0.5
    MultiSURF(backend="cpu").fit(X, y)
    root = [r for r in info_log.records
            if r.getMessage().startswith("fit[MultiSURF]")]
    assert len(root) == 1 and root[0].spans[0][1] == 0


def test_build_logs_one_record_with_its_counts(info_log, monkeypatch,
                                               tmp_path):
    class Lib:
        def __getattr__(self, name):
            fn = type("Fn", (), {})()
            setattr(self, name, fn)
            return fn
    monkeypatch.setattr(_build, "_lib", None)
    monkeypatch.setattr(_build, "library_path", lambda: tmp_path / "x.so")
    monkeypatch.setattr(_build, "build", lambda: tmp_path / "x.so")
    monkeypatch.setattr(_build.ctypes, "CDLL", lambda path: Lib())
    monkeypatch.setattr(_build, "ptxas_report", lambda: [("k", 1, 0)] * 9)
    with fs_logging.span("fit[X]"):
        _build.load()
        _build.load()
    msgs = [r.getMessage() for r in info_log.records]
    n = len(_build._SIGNATURES)
    assert msgs[0].startswith("build.kernels: ")
    assert msgs[0].endswith(f"n=1 kernels_compiled=9 kernels_loaded={n}")
    assert _RECORD.match(msgs[0])
    assert msgs[1].endswith(f"kernels_compiled=9 kernels_loaded={n}")
    assert len(msgs) == 2


# ---------------------------------------------------------------------------
# The profiler's trace
# ---------------------------------------------------------------------------

def test_profiler_trace_nests_the_spans(info_log, tmp_path, rng):
    X, y = rng.rand(60, 12), rng.randint(0, 2, 60)
    with profiling.trace(str(tmp_path)):
        MultiSURF(backend="cpu").fit(X, y)
    events = json.loads((tmp_path / "trace.json").read_text())["traceEvents"]
    ranges = {}
    for e in events:
        if e.get("cat") == "user_annotation" and e.get("ph") == "X":
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    tree = {"fit[MultiSURF]": None, "fit.validate": "fit[MultiSURF]",
            "fit.analysis": "fit[MultiSURF]", "fit.score": "fit[MultiSURF]",
            "fit.select": "fit[MultiSURF]", "fused.plan": "fit.score",
            "relief_cuda.engine[multisurf]": "fit.score",
            "fused.pass1": "relief_cuda.engine[multisurf]",
            "weight_rules": "relief_cuda.engine[multisurf]",
            "fused.pass2": "relief_cuda.engine[multisurf]"}
    assert set(tree) <= set(ranges)
    for name, parent in tree.items():
        if parent is None:
            assert len(ranges[name]) == 1
            continue
        (p0, p1), = ranges[parent]
        assert all(p0 <= a <= b <= p1 for a, b in ranges[name]), name
    # the records' starts (CLOCK_MONOTONIC) lie a constant offset from the
    # trace's (Unix time in us, less baseTimeNanoseconds)
    base = json.loads((tmp_path / "trace.json").read_text())[
        "baseTimeNanoseconds"]
    offset = time.time_ns() - time.perf_counter_ns()
    spans = _spans(info_log.records)
    for name, [(r0, _)] in ((n, ranges[n]) for n in ("fit[MultiSURF]",
                                                     "fit.score")):
        start = spans[name][0][2]
        assert abs(r0 * 1e3 + base - start - offset) < 5e6, name


# ---------------------------------------------------------------------------
# Names
# ---------------------------------------------------------------------------

def _span_names_in_source():
    """The literal names of every ``span(...)`` call in the package."""
    names = set()
    for path in (ROOT / "fastselect_tpu_torch").rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            func = getattr(node, "func", None)
            called = getattr(func, "id", getattr(func, "attr", ""))
            if called == "span" and node.args \
                    and isinstance(node.args[0], ast.Constant):
                names.add(node.args[0].value)
    return names


def test_new_span_names_leave_the_readers_prefixes(info_log, monkeypatch,
                                                   rng):
    source = _span_names_in_source()
    assert {"fit.validate", "fused.plan", "weight_rules", "discrete.pass1",
            "discrete.layout", "fused.pass2"} <= source
    assert STAGING_SPANS <= source
    for name in source - STAGING_SPANS:
        assert not name.startswith(READ_PREFIXES), name
    _fits(rng, monkeypatch)
    spans = {r.getMessage().split(":")[0] for r in info_log.records
             if "n=" in r.getMessage()}
    assert spans - STAGING_SPANS
    for name in spans - STAGING_SPANS:
        assert not name.startswith(READ_PREFIXES), name
