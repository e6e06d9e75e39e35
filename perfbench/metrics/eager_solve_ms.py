"""eager_solve_ms: the reading of ``solve_ms`` (its file says how it is
taken) in the host-bound cells, which report ``eager_solve_ms`` in
place of ``solve_ms``: their runs spread far wider, so their metrics
have bounds of their own."""

from pathlib import Path

from perfbench.harness import metric_module

_base = metric_module(Path(__file__).resolve().parents[2], "solve_ms")
read = _base.read
COUNTERS = getattr(_base, "COUNTERS", {})
