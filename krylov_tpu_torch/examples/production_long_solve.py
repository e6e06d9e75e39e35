"""Production pattern: a long solve as bounded chunks + checkpointing.

    python -m krylov_tpu_torch.examples.production_long_solve [--device cuda|cpu]

Two fault-tolerance layers compose:

1. ``solve(chunk_iters=N)``: the solve runs as N-iteration chunks.  For the
   eager loops of cg, mrr, the k-skip family, cacg and camrr the whole
   recurrence state is carried across chunks, so the iterations are
   exactly the unbroken solve's.
2. :mod:`krylov_tpu_torch.checkpoint`: persist the iterate to disk between
   runs and warm-resume after a process loss (restarted-Krylov semantics
   across the process boundary).
"""

import os
import tempfile

import numpy as np

import krylov_tpu_torch
from krylov_tpu_torch import checkpoint
from krylov_tpu_torch.examples import device_args
from krylov_tpu_torch.sparse.convert import to_hyb
from krylov_tpu_torch.sparse.fixtures import powerlaw_spd


def main(argv=None) -> None:
    args = device_args(__doc__.splitlines()[0], argv)
    krylov_tpu_torch.set_default_device(args.device)
    # An ill-conditioned irregular system (graded diagonal, kappa ~ 1e5 at
    # this size in float64; see sparse/fixtures.py).
    n = 4096
    P = powerlaw_spd(n, shift=1e-3, diag_scale_decades=1.5, seed=42)
    A = to_hyb(P)
    rng = np.random.default_rng(0)
    b = rng.standard_normal(n).astype(np.float64)

    # --- 1. chunked solve: identical iterations, bounded chunks -----------
    x_chunked, info = krylov_tpu_torch.solve(A, b, method="cg", tol=1e-4, maxiter=8000, chunk_iters=128)
    print(
        f"chunked: converged={info['converged']} iterations={info['iterations']}"
        f" chunks={info['chunks']}"
    )

    x_plain, info_plain = krylov_tpu_torch.solve(A, b, method="cg", tol=1e-4, maxiter=8000)
    assert info_plain["iterations"] == info["iterations"], "exact carry"
    print(f"matches unbroken solve: {info_plain['iterations']} iterations")

    # --- 2. checkpoint mid-solve, then resume in a 'new process' ----------
    with tempfile.TemporaryDirectory() as d:
        ckpt = os.path.join(d, "solve.npz")
        # The first run gets preempted after 200 iterations:
        x_partial, info1 = krylov_tpu_torch.solve(A, b, method="cg", tol=1e-4, maxiter=200, chunk_iters=128)
        checkpoint.save(ckpt, x_partial, info1, matrix="powerlaw_spd(4096)")
        # ...the process dies, restarts, resumes from disk:
        x_resumed, info2 = checkpoint.resume(A, b, ckpt, method="cg", tol=1e-4, maxiter=8000, chunk_iters=128)
        total = info1["iterations"] + info2["iterations"]
        true_res = float(np.linalg.norm(b - P @ x_resumed.cpu().numpy()) / np.linalg.norm(b))
        print(
            f"resumed: converged={info2['converged']} after "
            f"{info1['iterations']}+{info2['iterations']}={total} iterations, "
            f"true residual {true_res:.2e} "
            f"(resumed_from={info2['resumed_from']['prior_iterations']})"
        )


if __name__ == "__main__":
    main()
