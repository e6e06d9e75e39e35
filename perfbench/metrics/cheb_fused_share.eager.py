"""cheb_fused_share.eager: the share of the window's Chebyshev
preconditioner applications that ran on the Chebyshev step (K1 with the
recurrence's updates in its epilogue): ``cheb_apply.fused`` over
``cheb_apply.calls`` (``krylov_tpu_torch.tracing``), in percent, those
replayed in CUDA graphs counted at each replay.  It says how far the fused
route engages.  A program without the ``cheb_apply`` counter reports
nothing."""

from importlib import import_module

from perfbench import spans

KEYS = ("cheb_apply.fused", "cheb_apply.calls")


def _counters() -> dict:
    found = spans.counters(*KEYS)
    if found and not hasattr(import_module(spans.MODULE).totals, "cheb_apply"):
        return {}
    return found


COUNTERS = _counters()


def read(run):
    if not spans.found(run, KEYS) or run.counters["cheb_apply.calls"] <= 0:
        return None
    return 100.0 * run.counters["cheb_apply.fused"] / run.counters["cheb_apply.calls"]
