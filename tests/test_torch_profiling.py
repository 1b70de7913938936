"""The port's profiling, phase logging and process-group helpers, on the
CPU (``fastselect_tpu_torch/utils/{profiling,logging}.py``,
``parallel/distributed.py``)."""

import json
import logging
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from fastselect_tpu_torch import MultiSURF, SURF
from fastselect_tpu_torch.ops import relief_discrete as rd
from fastselect_tpu_torch.parallel import distributed
from fastselect_tpu_torch.utils import logging as fs_logging
from fastselect_tpu_torch.utils import profiling

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
H100 = "NVIDIA H100 80GB HBM3"


def test_timed_fit_tracks_peak_rss(rng):
    """tests/test_preprocessing.py:67: timed_fit samples host RSS during
    the fit; without a card the device peak is 0."""
    X = rng.rand(120, 40)
    y = rng.randint(0, 2, 120)
    t = profiling.timed_fit(lambda: MultiSURF(n_features_to_select=5), X, y)
    assert t.seconds > 0 and t.warmup_seconds > 0
    assert t.peak_rss_mb > 10  # a real process RSS, not a stub
    assert t.peak_device_mb == 0.0
    assert (t.n_samples, t.n_features) == (120, 40)
    assert t.throughput == pytest.approx(120 ** 2 * 40 / t.seconds)
    t2 = profiling.timed_fit(lambda: MultiSURF(n_features_to_select=5), X,
                             y, track_memory=False, warmup=False, repeats=2)
    assert t2.peak_rss_mb == 0.0 and t2.warmup_seconds < t.warmup_seconds


def test_timed_fit_reads_device_peaks(monkeypatch, rng):
    """With cards, the peak is the largest max_memory_allocated over the
    visible devices, each reset before the timed fit."""
    events = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda i=None: events.append(("sync", i)))
    monkeypatch.setattr(torch.cuda, "reset_peak_memory_stats",
                        lambda i: events.append(("reset", i)))
    monkeypatch.setattr(torch.cuda, "max_memory_allocated",
                        lambda i: [3 << 20, 5 << 20][i])
    X = rng.rand(40, 8)
    y = rng.randint(0, 2, 40)
    t = profiling.timed_fit(lambda: SURF(backend="cpu"), X, y)
    assert t.peak_device_mb == 5.0
    resets = [i for i, e in enumerate(events) if e[0] == "reset"]
    assert [events[i] for i in resets] == [("reset", 0), ("reset", 1)]
    # the warm-up fit ends synchronised, then the timed one
    assert events[:2] == [("sync", 0), ("sync", 1)]
    assert events[-2:] == [("sync", 0), ("sync", 1)]


def test_peaks_by_card_name(monkeypatch):
    assert profiling.peaks(H100) == (989.0, 1979.0, 67.0, 3350.0)
    assert profiling.peaks(H100).int8_tops == 1979.0
    for unknown in ("NVIDIA A100-SXM4-80GB", "TPU v5 lite", "cpu"):
        assert profiling.peaks(unknown) is None
    assert profiling.device_kind() == "cpu"          # no card here
    assert profiling.peaks() is None
    monkeypatch.setattr(profiling, "device_kind", lambda: H100)
    assert profiling.peaks() == profiling.PEAKS[H100]


def test_chip_smoke_takes_its_peaks_from_profiling():
    import chip_smoke as cs
    pk = profiling.PEAKS[H100]
    assert cs.INT8_PEAK_TOPS == pk.int8_tops
    assert cs.FP32_PEAK_FLOPS == pk.fp32_tflops * 1e12
    assert cs.HBM_BYTES_PER_S == pk.hbm_gbps * 1e9


@pytest.fixture
def info_log(caplog):
    caplog.set_level(logging.INFO, logger="fastselect_tpu_torch")
    return caplog


def test_phase_logs_at_info_and_syncs(monkeypatch, info_log):
    syncs = []
    monkeypatch.setattr(fs_logging, "_synchronize", lambda: syncs.append(1))
    with fs_logging.phase("work", work=1e6):
        pass
    with fs_logging.phase("plain"):
        pass
    msgs = [r.getMessage() for r in info_log.records]
    assert msgs[0].startswith("work: ") and "work/s" in msgs[0]
    assert msgs[1].startswith("plain: ") and "work/s" not in msgs[1]
    assert len(syncs) == 4            # at each phase's start and end


def test_phase_is_silent_and_never_syncs_below_info(monkeypatch, caplog):
    caplog.set_level(logging.WARNING, logger="fastselect_tpu_torch")
    monkeypatch.setattr(fs_logging, "_synchronize",
                        lambda: pytest.fail("synchronised below INFO"))
    with fs_logging.phase("quiet", work=1.0):
        pass
    assert caplog.records == []


def test_phase_synchronises_every_card(monkeypatch):
    seen = []
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    monkeypatch.setattr(torch.cuda, "synchronize", seen.append)
    fs_logging._synchronize()
    assert seen == [0, 1, 2]


def test_engines_log_their_phases(info_log, rng):
    """The phases sit where JAX's are: the fused engine, and the discrete
    engine's encoding, copy to the device and block loops."""
    X = rng.rand(60, 12)
    y = rng.randint(0, 2, 60)
    MultiSURF(backend="cpu").fit(X, y)
    codes = rng.randint(0, 3, (60, 12)).astype(np.int8)
    rd.relief_discrete_scores(None, y, algo="surf", codes=codes)
    rd.relief_discrete_scores(codes.astype(np.float32), y, algo="relieff",
                              n_neighbors=3)
    names = [r.getMessage().split(":")[0] for r in info_log.records]
    phases = [n for n in names if n.startswith("relief_")]
    assert phases == ["relief_cuda.engine[multisurf]", "relief_discrete.h2d",
                      "relief_discrete.engine[surf]",
                      "relief_discrete.encode",
                      "relief_discrete.engine[relieff]"]
    # the fit's spans, and those each engine phase holds, logged before it
    assert names[:names.index("relief_discrete.h2d")] == [
        "fused.pass1", "weight_rules", "weight_rules.stats", "fused.pass2",
        "relief_cuda.engine[multisurf]", "fit[MultiSURF]", "fit.validate",
        "fit.analysis", "fit.score", "fused.plan", "fit.select"]
    # SURF's rule takes the row statistics, ReliefF's none
    for engine, rules in (("relief_discrete.engine[surf]",
                           ["weight_rules", "weight_rules.stats"]),
                          ("relief_discrete.engine[relieff]",
                           ["weight_rules"])):
        i = names.index(engine)
        assert names[i - len(rules) - 2:i] == (
            ["discrete.pass1"] + rules + ["discrete.pass2"])
    assert set(names) - set(phases) == {
        "fused.pass1", "weight_rules", "weight_rules.stats", "fused.pass2",
        "fit[MultiSURF]", "fit.validate", "fit.analysis", "fit.score",
        "fused.plan", "fit.select", "discrete.pass1", "discrete.pass2"}


def test_engines_log_the_v2_phase(monkeypatch, info_log, rng):
    monkeypatch.setattr(rd, "_V2_MIN_N", 16)
    codes = rng.randint(0, 3, (60, 12)).astype(np.int8)
    y = rng.randint(0, 2, 60)
    rd.relief_discrete_scores(None, y, algo="multisurf",
                              codes=torch.from_numpy(codes))
    names = [r.getMessage().split(":")[0] for r in info_log.records]
    assert [n for n in names if n.startswith("relief_")] == [
        "relief_discrete.engine_v2[multisurf]"]
    # the phase's spans in order of first opening (the symmetric tier:
    # the one-hot, pass 1's match matrix, then each focal block's rules
    # and pass 2), then the phase itself
    assert names == ["discrete.layout", "discrete.pass1", "weight_rules",
                     "weight_rules.stats", "discrete.pass2",
                     "relief_discrete.engine_v2[multisurf]"]


def test_trace_writes_a_chrome_trace_on_the_cpu(tmp_path, rng):
    X = rng.rand(40, 8)
    y = rng.randint(0, 2, 40)
    with profiling.trace(str(tmp_path / "t")) as prof:
        MultiSURF(backend="cpu").fit(X, y)
    out = tmp_path / "t" / "trace.json"
    events = json.loads(out.read_text())["traceEvents"]
    assert any("aten::" in e.get("name", "") for e in events)
    assert prof.key_averages()


def test_initialize_is_a_noop_in_one_process(monkeypatch):
    for var in ("WORLD_SIZE", "RANK", "MASTER_ADDR", "MASTER_PORT"):
        monkeypatch.delenv(var, raising=False)
    distributed.initialize()
    distributed.initialize(num_processes=1)
    assert not torch.distributed.is_initialized()
    assert distributed.is_multihost() is False


def test_initialize_raises_when_the_coordinator_is_unreachable():
    """A second process whose coordinator never comes up gets a clear
    RuntimeError after the timeout (localhost, a port nobody listens on)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    with pytest.raises(RuntimeError, match="a peer is unreachable"):
        distributed.initialize(f"localhost:{port}", num_processes=2,
                               process_id=1, timeout_s=2)
    assert not torch.distributed.is_initialized()


def test_parallel_and_utils_import_no_jax():
    """A fresh interpreter importing the port's parallel layer, profiling,
    logging, chip_smoke.py and the multi-process tests' worker module (what
    a spawned worker imports) imports neither jax nor fastselect_tpu."""
    code = ("import json, sys\n"
            "sys.path.insert(0, 'tests')\n"
            "import chip_smoke\n"
            "import torch_mp_workers\n"
            "import fastselect_tpu_torch.parallel\n"
            "import fastselect_tpu_torch.parallel.distributed\n"
            "import fastselect_tpu_torch.utils.profiling\n"
            "import fastselect_tpu_torch.utils.logging\n"
            "print(json.dumps([m for m in ('jax', 'fastselect_tpu') "
            "if m in sys.modules]))")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
