"""The four-card cell's twin readers, ``allreduces_per_solve.eager`` and
``comm_ms_per_solve.eager``: each reads as the reader it loads (the
program's all-reduce count over the window's requests; the NCCL kernels'
device time over the stretch's), asks for counters the program has, reads
nothing where it finds nothing, and a traced run of the cell on the CPU
reports the count (no device trace there: no NCCL time)."""

import types

import pytest

from perfbench.harness import metric_module, read_counters
from perfbench.tests._runner import MESH_CELL, ROOT, run_cell

TWINS = ("allreduces_per_solve.eager", "comm_ms_per_solve.eager")


class _Trace:
    """A profiled stretch of two NCCL kernels and a K1 launch."""

    records = {"ncclDevKernel_AllReduce_Sum_f64": 0.004, "ncclDevKernel_SendRecv": 0.002,
               "stencil2d_kernel<double, 7>": 0.010}

    def kernels(self, pattern=None):
        return [name for name in self.records if pattern is None or pattern.search(name)]

    def seconds(self, launches):
        return sum(self.records[name] for name in launches)


@pytest.mark.parametrize("name", TWINS)
def test_twin_reads_as_its_base(name):
    twin, base = metric_module(ROOT, name), metric_module(ROOT, name.rsplit(".", 1)[0])
    run = types.SimpleNamespace(requests=4, counters={"all_reduce": 264}, trace=_Trace(), stretch_requests=3)
    assert twin.read(run) == base.read(run)
    assert twin.COUNTERS == getattr(base, "COUNTERS", {})


def test_allreduces_divides_the_windows_count():
    reader = metric_module(ROOT, "allreduces_per_solve.eager")
    run = types.SimpleNamespace(requests=4, counters={"all_reduce": 264})
    assert reader.read(run) == pytest.approx(66.0)
    assert set(read_counters(reader.COUNTERS)) == {"all_reduce"}


def test_comm_reads_the_nccl_kernels_alone():
    reader = metric_module(ROOT, "comm_ms_per_solve.eager")
    run = types.SimpleNamespace(trace=_Trace(), stretch_requests=3)
    assert reader.read(run) == pytest.approx(2.0)  # 6 ms of NCCL kernels over 3 requests
    run.trace.records = {"stencil2d_kernel<double, 7>": 0.010}
    assert reader.read(run) is None
    assert reader.read(types.SimpleNamespace(trace=None, stretch_requests=3)) is None


def test_traced_mesh_cell_reports_the_count():
    code, line, _, err = run_cell(MESH_CELL, seed=2**31 + 17, trace=1)
    assert code == 0, err[-3000:]
    assert line["correct"] is True
    metrics = line["metrics"]
    assert metrics["allreduces_per_solve.eager"]["value"] > 0
    assert "comm_ms_per_solve.eager" not in metrics  # no device trace off a card
    assert metrics["graph_body_share.eager"]["value"] == 0  # no CUDA graph off a card
