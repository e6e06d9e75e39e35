"""Production pattern: amortized multi-RHS solves on general sparse.

    python -m krylov_tpu_torch.examples.multi_rhs_solve [--device cuda|cpu]

``solve_batched`` runs a whole ``(batch, N)`` block through one eager CG
loop: each HYB SpMV gathers the block once per stored entry (the batch
leads), and each member keeps its own convergence point, converged
systems freezing while the rest iterate.  Typical uses: multiple load
cases of one structure, multiple sources in one field problem.
"""

import numpy as np
import torch

import krylov_tpu_torch
from krylov_tpu_torch.examples import device_args
from krylov_tpu_torch.sparse.convert import to_hyb
from krylov_tpu_torch.sparse.fixtures import powerlaw_spd


def main(argv=None) -> None:
    args = device_args(__doc__.splitlines()[0], argv)
    krylov_tpu_torch.set_default_device(args.device)
    n, nrhs = 1 << 14, 8
    A_sp = powerlaw_spd(n, seed=0)
    A = to_hyb(A_sp, dtype=torch.float32)

    rng = np.random.default_rng(7)
    B = rng.standard_normal((nrhs, n)).astype(np.float32)  # (batch, N)

    # one loop for the whole batch; the result's fields carry the batch axis
    res = krylov_tpu_torch.solve_batched(A, B, method="cg", tol=1e-5, maxiter=2000)

    X = res.x.cpu().numpy()  # (batch, N)
    iters = res.iterations.cpu().numpy()
    converged = res.converged.cpu().numpy()
    for i in range(nrhs):
        true = np.linalg.norm(B[i] - A_sp @ X[i].astype(np.float64)) / np.linalg.norm(B[i])
        print(
            f"system {i}: {int(iters[i]):4d} iterations, "
            f"converged={bool(converged[i])}, "
            f"true residual {true:.2e}"
        )
    assert converged.all()


if __name__ == "__main__":
    main()
