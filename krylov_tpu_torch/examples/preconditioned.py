"""Preconditioned + pipelined CG family with the port's preconditioners.

    python -m krylov_tpu_torch.examples.preconditioned [--device cuda|cpu]

On a card every SpMV of these eager loops on the stencil is K1, and a
degree-d Chebyshev application is d - 1 launches of the Chebyshev step.
"""

import torch

import krylov_tpu_torch
from krylov_tpu_torch import precond
from krylov_tpu_torch.examples import device_args
from krylov_tpu_torch.sparse.fixtures import laplace2d


def main(argv=None) -> None:
    args = device_args(__doc__.splitlines()[0], argv)
    krylov_tpu_torch.set_default_device(args.device)
    A = laplace2d(48, dtype=torch.float32)
    b = torch.ones(A.shape[0], dtype=torch.float32, device=A.device)

    for name, M in [
        ("identity", None),
        ("jacobi", precond.jacobi(A)),
        ("chebyshev(6)", precond.chebyshev(A, degree=6)),
    ]:
        for method in ["pcg", "chronopoulos_gear", "gropp", "pipelined_cg"]:
            # tol=1e-4: this demo runs in float32, where the TRUE residual
            # floors at ~eps_f32 * kappa(A) ~ 1e-4 on this grid; pipelined
            # CG's residual replacement makes its recurred residual track
            # the true one, so it reports that floor (use refine= /
            # restarts= or float64 for tighter tolerances).
            x, info = krylov_tpu_torch.solve(A, b, method=method, M=M, tol=1e-4)
            print(
                f"{method:18s} M={name:13s} iters={info['iterations']:4d} "
                f"converged={info['converged']}"
            )


if __name__ == "__main__":
    main()
