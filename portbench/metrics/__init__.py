"""Per-layer metrics, one file a metric, found by the metric's name in
``BENCHMARK.json``.  Each declares ``LAYER``, ``UNIT``, ``SOURCE``,
``MOVES`` and ``WORKLOADS`` as ``BENCHMARK.json`` has them, and
``read(ctx)`` (ctx: ``harness.TraceContext``) returns the value, a
(value, extra keys) pair, or None where it finds nothing to read."""
