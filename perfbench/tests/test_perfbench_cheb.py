"""The reader of the Chebyshev step's share, ``cheb_fused_share.eager``: it
divides the window's counters, reports in the pcg cell's traced run on the
CPU (where every application runs the loop, so it reads 0), and a checkout
whose program has no ``cheb_apply`` counter leaves it out of the line
without failing."""

import types

import pytest

from perfbench import spans
from perfbench.harness import metric_module, read_counters
from perfbench.tests._runner import ROOT, run_cell

NAME = "cheb_fused_share.eager"


def test_reader_divides_the_windows_counters():
    run = types.SimpleNamespace(requests=2, counters={"cheb_apply.fused": 570, "cheb_apply.calls": 570})
    assert metric_module(ROOT, NAME).read(run) == pytest.approx(100.0)
    run.counters["cheb_apply.fused"] = 285
    assert metric_module(ROOT, NAME).read(run) == pytest.approx(50.0)
    run.counters["cheb_apply.calls"] = 0
    assert metric_module(ROOT, NAME).read(run) is None


def test_reader_asks_for_counters_the_program_has():
    reader = metric_module(ROOT, NAME)
    assert set(reader.COUNTERS) == {"cheb_apply.fused", "cheb_apply.calls"}
    assert set(read_counters(reader.COUNTERS)) == set(reader.COUNTERS)


def test_reader_reads_nothing_without_the_programs_counter(monkeypatch):
    """A checkout from before the Chebyshev step: its ``tracing.totals``
    has no ``cheb_apply``, so no counter is asked for and no value read."""
    from krylov_tpu_torch import tracing

    monkeypatch.delattr(tracing.totals, "cheb_apply")
    reader = metric_module(ROOT, NAME)
    assert reader.COUNTERS == {}
    assert reader.read(types.SimpleNamespace(counters={}, requests=3)) is None
    monkeypatch.setattr(spans, "find_spec", lambda module: None)
    assert metric_module(ROOT, NAME).COUNTERS == {}


def test_traced_pcg_cell_reports_the_share():
    code, line, _, err = run_cell("p2d-pcg-cheb6-1rhs", seed=2**31 + 11, trace=1)
    assert code == 0, err[-3000:]
    assert line["correct"] is True
    assert line["metrics"][NAME]["value"] == 0  # the CPU runs the loop
