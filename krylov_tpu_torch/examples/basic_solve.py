"""Basic usage: solve SPD systems with every method, reference-style report.

    python -m krylov_tpu_torch.examples.basic_solve [--device cuda|cpu]

On a card the 2-D stencil goes to the fused whole-solve kernels.
"""

import numpy as np
import torch

import krylov_tpu_torch
from krylov_tpu_torch.examples import device_args
from krylov_tpu_torch.sparse.fixtures import laplace2d


def main(argv=None) -> None:
    args = device_args(__doc__.splitlines()[0], argv)
    krylov_tpu_torch.set_default_device(args.device)
    A = laplace2d(64, dtype=torch.float32)  # 2-D 5-point Laplacian, N=4096
    rng = np.random.default_rng(0)
    b = torch.as_tensor(rng.standard_normal(A.shape[0]).astype(np.float32), device=A.device)

    for method, kw in [
        ("cg", {}),
        ("mrr", {}),
        ("kskipcg", {"k": 4}),
        ("kskipmrr", {"k": 2}),
        ("adaptivekskipmrr", {"k": 3}),
    ]:
        x, info = krylov_tpu_torch.solve(A, b, method=method, tol=1e-5, verbose=True, **kw)
        true_res = torch.linalg.vector_norm(b - A.matvec(x)) / torch.linalg.vector_norm(b)
        print(f"-> true relative residual: {float(true_res):.3e}\n")


if __name__ == "__main__":
    main()
