"""Runnable examples of :mod:`krylov_tpu_torch`, the counterparts of the
JAX package's ``examples/`` scripts, with their systems, methods and
printed lines:

    python -m krylov_tpu_torch.examples.basic_solve [--device cuda|cpu]
    python -m krylov_tpu_torch.examples.preconditioned [--device ...]
    python -m krylov_tpu_torch.examples.multi_rhs_solve [--device ...]
    python -m krylov_tpu_torch.examples.production_long_solve [--device ...]
    python -m krylov_tpu_torch.examples.distributed_solve [--device ...] [--ranks R]

``--device`` defaults to ``cuda``.  On a card ``basic_solve`` runs the
fused whole-solve kernels (K3/K2/K6/K5), ``preconditioned`` and
``distributed_solve`` the eager loops over K1, ``multi_rhs_solve`` and
``production_long_solve`` the HYB operator's eager path.
"""

import argparse


def device_args(description: str, argv=None, **extra) -> argparse.Namespace:
    """The examples' command line: ``--device`` (default ``cuda``) and the
    options ``extra`` names (``name=(type, default, help)``)."""
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--device", default="cuda", help="the torch device to solve on (default cuda)")
    for name, (kind, default, text) in extra.items():
        ap.add_argument(f"--{name}", type=kind, default=default, help=text)
    return ap.parse_args(argv)
