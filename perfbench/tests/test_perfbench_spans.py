"""The readers of the program's spans and host-read counters: each cell's
traced run on the CPU reports them, and a checkout whose program has no
``krylov_tpu_torch.tracing`` leaves them out of the line without
failing."""

import types

import pytest

from perfbench import spans
from perfbench.harness import metric_module
from perfbench.tests._runner import ROOT, run_cell

CELLS = {
    "p2d-mrr-1rhs": ("front_door_ms", "host_reads_per_solve"),
    "p3d-amrr8-1rhs": ("front_door_ms", "host_reads_per_solve"),
    "p2d-pcg-cheb6-1rhs": ("host_reads_per_solve.eager", "loop_host_us_per_body"),
}
READERS = sorted({name for names in CELLS.values() for name in names})


@pytest.mark.parametrize("workload", sorted(CELLS))
def test_traced_cell_reports_the_span_metrics(workload):
    code, line, _, err = run_cell(workload, seed=2**31 + 5, trace=1)
    assert code == 0, err[-3000:]
    assert line["correct"] is True
    got = line["metrics"]
    assert set(CELLS[workload]) <= set(got)
    assert all(got[name]["value"] > 0 for name in CELLS[workload])
    reads = got.get("host_reads_per_solve") or got["host_reads_per_solve.eager"]
    if workload == "p2d-mrr-1rhs":
        # the b = 0 test alone: K2's plain version on the CPU reads nothing
        # through a span, as K2 reads nothing on the card
        assert reads["value"] == 1
    else:
        # p3d: the b = 0 test, the restart decision, and on the CPU the
        # guard reads of K5's plain version (the eager adaptive loop);
        # pcg: the b = 0 test and one read a 32-body block
        assert reads["value"] >= 2


@pytest.mark.parametrize("name", READERS)
def test_reader_reads_nothing_without_the_programs_spans(name, monkeypatch):
    """A checkout from before the spans: no counters asked for, no value."""
    monkeypatch.setattr(spans, "find_spec", lambda module: None)
    assert spans.counters("host_read.calls") == {}
    reader = metric_module(ROOT, name)
    assert reader.COUNTERS == {}
    run = types.SimpleNamespace(counters={}, requests=3)
    assert reader.read(run) is None


def test_readers_divide_the_windows_counters():
    run = types.SimpleNamespace(requests=4, counters={
        "host_read.calls": 8,
        "solve_device.self_ns": 1_000_000, "plan.self_ns": 2_000_000, "run_fused.self_ns": 3_000_000,
        "launch.self_ns": 4_000_000, "restarts.self_ns": 6_000_000,
        "eager_loop.total_ns": 90_000, "eager_loop.read_ns": 26_000, "eager_bodies.calls": 64,
    })
    assert metric_module(ROOT, "host_reads_per_solve").read(run) == 2
    assert metric_module(ROOT, "host_reads_per_solve.eager").read(run) == 2
    assert metric_module(ROOT, "front_door_ms").read(run) == pytest.approx(4.0)
    assert metric_module(ROOT, "loop_host_us_per_body").read(run) == pytest.approx(1.0)
    assert spans.counters("host_read.calls") == {"host_read.calls": "krylov_tpu_torch.tracing:totals.host_read.calls"}
