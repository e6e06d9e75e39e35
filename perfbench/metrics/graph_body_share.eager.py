"""graph_body_share.eager: the share of the window's eager loop bodies that
ran inside CUDA graph replays: ``eager_graph.bodies`` over
``eager_bodies.calls`` (``krylov_tpu_torch.tracing``), in percent.  It says
how far the eager loops' graph route engages: each body a replay runs is a
body the host did not launch kernel by kernel.  A program without the
``eager_graph`` counter reports nothing."""

from importlib import import_module

from perfbench import spans

KEYS = ("eager_graph.bodies", "eager_bodies.calls")


def _counters() -> dict:
    found = spans.counters(*KEYS)
    if found and not hasattr(import_module(spans.MODULE).totals, "eager_graph"):
        return {}
    return found


COUNTERS = _counters()


def read(run):
    if not spans.found(run, KEYS) or run.counters["eager_bodies.calls"] <= 0:
        return None
    return 100.0 * run.counters["eager_graph.bodies"] / run.counters["eager_bodies.calls"]
