"""The reader of the pcg body's share on its kernels,
``pcg_body_fused_share.eager``: it divides the window's counters, reports
in the pcg cell's traced run on the CPU (where every body runs torch's
passes, so it reads 0), and a checkout whose program has no ``pcg_body``
counter leaves it out of the line without failing."""

import types

import pytest

from perfbench import spans
from perfbench.harness import metric_module, read_counters
from perfbench.tests._runner import ROOT, run_cell

NAME = "pcg_body_fused_share.eager"


def test_reader_divides_the_windows_counters():
    run = types.SimpleNamespace(requests=2, counters={"pcg_body.fused": 576, "pcg_body.calls": 576})
    assert metric_module(ROOT, NAME).read(run) == pytest.approx(100.0)
    run.counters["pcg_body.fused"] = 288
    assert metric_module(ROOT, NAME).read(run) == pytest.approx(50.0)
    run.counters["pcg_body.calls"] = 0
    assert metric_module(ROOT, NAME).read(run) is None


def test_reader_asks_for_counters_the_program_has():
    reader = metric_module(ROOT, NAME)
    assert set(reader.COUNTERS) == {"pcg_body.fused", "pcg_body.calls"}
    assert set(read_counters(reader.COUNTERS)) == set(reader.COUNTERS)


def test_reader_reads_nothing_without_the_programs_counter(monkeypatch):
    """A checkout from before the pcg kernels: its ``tracing.totals`` has
    no ``pcg_body``, so no counter is asked for and no value read."""
    from krylov_tpu_torch import tracing

    monkeypatch.delattr(tracing.totals, "pcg_body")
    reader = metric_module(ROOT, NAME)
    assert reader.COUNTERS == {}
    assert reader.read(types.SimpleNamespace(counters={}, requests=3)) is None
    monkeypatch.setattr(spans, "find_spec", lambda module: None)
    assert metric_module(ROOT, NAME).COUNTERS == {}


def test_traced_pcg_cell_reports_the_share():
    code, line, _, err = run_cell("p2d-pcg-cheb6-1rhs", seed=2**31 + 13, trace=1)
    assert code == 0, err[-3000:]
    assert line["correct"] is True
    assert line["metrics"][NAME]["value"] == 0  # the CPU runs torch's passes
