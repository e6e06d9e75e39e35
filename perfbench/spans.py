"""The program's span totals and host-read counters
(``krylov_tpu_torch.tracing.totals``) as the metric readers ask the
harness for them.

:func:`counters` gives a reader's ``COUNTERS``: each ``"<span>.<field>"``
mapped to its ``module:attr.path``, or nothing where the checkout's program
has no ``krylov_tpu_torch.tracing`` (one from before it), so that the
reader then finds nothing to read and its metric is left out of the line.
"""

from importlib.util import find_spec

MODULE = "krylov_tpu_torch.tracing"


def counters(*keys) -> dict:
    """``{key: "krylov_tpu_torch.tracing:totals.<key>"}`` for each
    ``"<span>.<field>"`` key, or ``{}`` without the module."""
    if find_spec(MODULE) is None:
        return {}
    return {key: f"{MODULE}:totals.{key}" for key in keys}


def found(run, keys) -> bool:
    """Whether the window's counters hold every key."""
    return all(key in run.counters for key in keys)
