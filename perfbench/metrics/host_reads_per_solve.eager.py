"""host_reads_per_solve.eager: the reading of ``host_reads_per_solve`` (its
file says how it is taken) in the host-bound cells, which report
``eager_solve_ms`` in place of ``solve_ms``."""

from pathlib import Path

from perfbench.harness import metric_module

_base = metric_module(Path(__file__).resolve().parents[2], "host_reads_per_solve")
read = _base.read
COUNTERS = getattr(_base, "COUNTERS", {})
