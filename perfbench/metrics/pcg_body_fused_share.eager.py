"""pcg_body_fused_share.eager: the share of the window's preconditioned CG
eager bodies whose vector and scalar work ran on the four kernels of
``krylov_tpu_torch.kernels.pcg`` (in place of torch's passes):
``pcg_body.fused`` over ``pcg_body.calls`` (``krylov_tpu_torch.tracing``),
in percent, those replayed in CUDA graphs counted at each replay.  It says
how far the kernels' route engages.  A program without the ``pcg_body``
counter reports nothing."""

from importlib import import_module

from perfbench import spans

KEYS = ("pcg_body.fused", "pcg_body.calls")


def _counters() -> dict:
    found = spans.counters(*KEYS)
    if found and not hasattr(import_module(spans.MODULE).totals, "pcg_body"):
        return {}
    return found


COUNTERS = _counters()


def read(run):
    if not spans.found(run, KEYS) or run.counters["pcg_body.calls"] <= 0:
        return None
    return 100.0 * run.counters["pcg_body.fused"] / run.counters["pcg_body.calls"]
