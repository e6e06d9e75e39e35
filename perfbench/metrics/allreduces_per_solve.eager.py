"""allreduces_per_solve.eager: the reading of ``allreduces_per_solve`` (its
file says how it is taken) in the cells that report ``eager_solve_ms`` in
place of ``solve_ms``: the four-card cell, whose eager loop's runs spread
wider, so its metrics have bounds of their own."""

from pathlib import Path

from perfbench.harness import metric_module

_base = metric_module(Path(__file__).resolve().parents[2], "allreduces_per_solve")
read = _base.read
COUNTERS = getattr(_base, "COUNTERS", {})
