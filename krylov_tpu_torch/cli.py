"""Command-line driver: ``python -m krylov_tpu_torch``.

The counterpart of :mod:`krylov_tpu.cli`, with the same subcommands,
flags, ``condition.json`` schema, override order (flags over the config
file) and exit codes (0 converged, 1 not converged, 2 bad input)::

    python -m krylov_tpu_torch solve --matrix A.mtx --method kskipmrr --k 4
    python -m krylov_tpu_torch solve --config condition.json
    python -m krylov_tpu_torch info  --matrix A.npz

``condition.json`` (every key optional but the system source)::

    {
      "matrix":  "path.mtx" | "path.npz" | "path.npy"
                 | {"fixture": "laplace2d", "n": 512, ...},  // extra keys
                                                            // go to the fixture
      "b":       "path.npy" | "ones" | "random",       // default "ones"
      "method":  "cg",                                  // any solve() method
      "k":        0,
      "tol":      1e-5,
      "maxiter":  null,
      "dtype":   "float32" | "float64",
      "refine":   0,
      "chunk_iters": null,    // bounded chunks, exact for the carry methods
      "basis_norm": false,    // k-skip: pow2-normalized Krylov chains
      "scalar_dtype": null | "float64",   // wide scalar recurrences
      "precond": null | "jacobi" | "chebyshev",
      "mesh":     false,      // true => row-partitioned over the ranks (below)
      "out":     "solution.npz"   // checkpoint.save() format
    }

``"b": "random"`` is ``numpy.random.default_rng(0).standard_normal(n)``.
The one flag the JAX driver lacks is ``--device`` (default ``cuda``): the
device the operator and the solve run on, where the JAX driver runs on
JAX's platform.  ``--mesh`` (``"mesh": true``) solves row-partitioned
(:mod:`krylov_tpu_torch.dist`) over the world ``torchrun`` started, one
rank a card (``torchrun --nproc-per-node 4 -m krylov_tpu_torch solve
--mesh ...``; rank 0 writes ``out``), or, run alone, over a world of one on
``--device``: NCCL on a card, gloo on the CPU.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import sys
import tempfile
from typing import Optional

import numpy as np

_FIXTURES = ("poisson1d", "laplace2d", "laplace3d", "random_spd_ell", "powerlaw_spd")


def _load_matrix(spec, dtype=None, device=None):
    """Operator of a matrix source: a file path or a fixture dict."""
    from krylov_tpu_torch.sparse import fixtures, io
    from krylov_tpu_torch.sparse.formats import as_operator

    if isinstance(spec, dict):
        name = spec.get("fixture")
        if name not in _FIXTURES:
            raise ValueError(f"unknown fixture {name!r}; available: {_FIXTURES}")
        kwargs = {k: v for k, v in spec.items() if k != "fixture"}
        if dtype is not None:
            kwargs.setdefault("dtype", dtype)
        if name != "powerlaw_spd":  # it returns a scipy matrix
            kwargs.setdefault("device", device)
        # "n" is the size whatever the fixture calls its first argument
        size = kwargs.pop("n", None)
        fn = getattr(fixtures, name)
        A = fn(size, **kwargs) if size is not None else fn(**kwargs)
        return as_operator(A, dtype=dtype, device=device)
    path = str(spec)
    if path.endswith(".mtx") or path.endswith(".mtx.gz"):
        return io.load_mtx(path, dtype=dtype, device=device)
    if path.endswith(".npz"):
        return io.load_npz(path, dtype=dtype, device=device)
    if path.endswith(".npy"):
        return io.load_npy(path, dtype=dtype, device=device)
    raise ValueError(f"unrecognized matrix file type: {path!r}")


def _load_rhs(spec, n: int, dtype) -> np.ndarray:
    if spec in (None, "ones"):
        return np.ones(n, dtype=dtype)
    if spec == "random":
        return np.random.default_rng(0).standard_normal(n).astype(dtype)
    b = np.load(str(spec))
    if b.shape != (n,):
        raise ValueError(f"b from {spec!r} has shape {b.shape}, need ({n},)")
    return b.astype(dtype)


def _make_precond(name: Optional[str], A):
    if name in (None, "", "none"):
        return None
    from krylov_tpu_torch import precond

    if name == "jacobi":
        return precond.jacobi(A)
    if name == "chebyshev":
        return precond.chebyshev(A)
    raise ValueError(f"unknown preconditioner {name!r}")


def _mesh(device, stack: contextlib.ExitStack):
    """The rows mesh of ``--mesh``: over the world ``torchrun`` started
    (read from its environment) or, without one, a world of one on
    ``device`` (a ``file://`` store in a temporary directory).  A world made
    here is destroyed when ``stack`` closes."""
    import torch
    import torch.distributed as dist

    from krylov_tpu_torch.device import resolve
    from krylov_tpu_torch.dist import make_mesh

    dev = resolve(device)
    if not dist.is_initialized():
        kw = {}
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", dev.index or 0)))
            kw["device_id"] = torch.device("cuda", torch.cuda.current_device())
        backend = "nccl" if dev.type == "cuda" else "gloo"
        if "WORLD_SIZE" in os.environ:
            dist.init_process_group(backend, **kw)
        else:
            store = os.path.join(stack.enter_context(tempfile.TemporaryDirectory()), "store")
            dist.init_process_group(backend, init_method=f"file://{store}", rank=0, world_size=1, **kw)
        stack.callback(dist.destroy_process_group)
    return make_mesh(dev.type)


def _cmd_solve(args) -> int:
    with contextlib.ExitStack() as stack:
        return _solve(args, stack)


def _solve(args, stack: contextlib.ExitStack) -> int:
    import torch

    import krylov_tpu_torch

    cfg = {}
    if args.config:
        with open(args.config) as f:
            cfg = json.load(f)
    for key in ("matrix", "b", "method", "k", "tol", "maxiter", "dtype", "refine", "precond", "out", "chunk_iters",
                "scalar_dtype"):
        v = getattr(args, key, None)
        if v is not None:
            cfg[key] = v
    if args.mesh:
        cfg["mesh"] = True
    if args.basis_norm:
        cfg["basis_norm"] = True
    if args.fixture:
        cfg["matrix"] = {"fixture": args.fixture, "n": args.n}

    if "matrix" not in cfg:
        print("error: no matrix given (--matrix/--fixture or config)", file=sys.stderr)
        return 2

    dtype = np.dtype(cfg.get("dtype", "float32"))
    scalar_dtype = cfg.get("scalar_dtype")
    if scalar_dtype is not None:
        # config values bypass argparse's choices=
        if str(scalar_dtype) not in ("float32", "float64"):
            print(f"error: scalar_dtype must be 'float32' or 'float64', got {scalar_dtype!r}", file=sys.stderr)
            return 2
        scalar_dtype = getattr(torch, str(scalar_dtype))
    mesh = _mesh(args.device, stack) if cfg.get("mesh") else None
    A = _load_matrix(cfg["matrix"], dtype=getattr(torch, dtype.name), device=args.device)
    b = _load_rhs(cfg.get("b"), A.shape[0], dtype)
    M = _make_precond(cfg.get("precond"), A)

    x, info = krylov_tpu_torch.solve(
        A,
        b,
        method=cfg.get("method", "cg"),
        tol=float(cfg.get("tol", 1e-5)),
        maxiter=cfg.get("maxiter"),
        k=int(cfg.get("k", 0)),
        M=M,
        mesh=mesh,
        refine=int(cfg.get("refine", 0)),
        scalar_dtype=scalar_dtype,
        basis_norm=bool(cfg.get("basis_norm", False)),
        chunk_iters=int(cfg["chunk_iters"]) if cfg.get("chunk_iters") else None,
        verbose=not args.quiet,
    )

    out = cfg.get("out")
    if out and (mesh is None or mesh.get_rank() == 0):
        from krylov_tpu_torch import checkpoint

        checkpoint.save(out, x, info, method=cfg.get("method", "cg"), tol=float(cfg.get("tol", 1e-5)))
        if not args.quiet:
            print(f"solution -> {out}")
    return 0 if info["converged"] else 1


def _cmd_info(args) -> int:
    from krylov_tpu_torch.sparse.formats import DiaMatrix, EllMatrix, StencilMatrix, as_numpy_dtype

    A = _load_matrix({"fixture": args.fixture, "n": args.n} if args.fixture else args.matrix, device=args.device)
    n = A.shape[0]
    report = {
        "shape": list(A.shape),
        "container": type(A).__name__,
        "dtype": str(as_numpy_dtype(A.dtype)),
        "nnz": int(A.nnz),
        "nnz_per_row": round(A.nnz / n, 3),
    }
    if isinstance(A, StencilMatrix):
        report["grid"] = list(A.grid)
        report["stencil_points"] = len(A.stencil)
    elif isinstance(A, DiaMatrix):
        report["diagonals"] = len(A.offsets)
        report["bandwidth"] = int(max(abs(o) for o in A.offsets))
    elif isinstance(A, EllMatrix):
        report["ell_width"] = int(A.data.shape[1])
    print(json.dumps(report, indent=2))
    return 0


def _add_common_args(p):
    p.add_argument("--matrix", help=".mtx/.npz/.npy matrix file")
    p.add_argument("--fixture", choices=_FIXTURES, help="built-in test operator")
    p.add_argument("--n", type=int, default=64, help="fixture size parameter (default 64)")
    p.add_argument("--device", default="cuda", help="torch device of the operator and the solve (default cuda)")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="python -m krylov_tpu_torch",
                                description="PyTorch/CUDA Krylov solver driver")
    sub = p.add_subparsers(dest="command", required=True)

    s = sub.add_parser("solve", help="solve an SPD system A x = b")
    _add_common_args(s)
    s.add_argument("--config", help="condition.json driver config")
    s.add_argument("--b", help="'ones' | 'random' | path.npy")
    s.add_argument("--method", help="cg/mrr/kskipcg/kskipmrr/... (see docs)")
    s.add_argument("--k", type=int, help="k for k-skip methods")
    s.add_argument("--tol", type=float, help="relative residual tolerance")
    s.add_argument("--maxiter", type=int)
    s.add_argument("--dtype", choices=["float32", "float64"])
    s.add_argument("--refine", type=int, help="mixed-precision refinement steps")
    s.add_argument("--basis-norm", dest="basis_norm", action="store_true",
                   help="k-skip: pow2-normalized Krylov chains (float32 stability on ill-conditioned systems)")
    s.add_argument("--scalar-dtype", dest="scalar_dtype", choices=["float32", "float64"],
                   help="dtype for scalar recurrences")
    s.add_argument("--chunk-iters", dest="chunk_iters", type=int,
                   help="run the solve in chunks of this many iterations (exact state carry for "
                        "cg/mrr/the k-skip family/cacg/camrr; warm restart otherwise)")
    s.add_argument("--precond", choices=["none", "jacobi", "chebyshev"])
    s.add_argument("--mesh", action="store_true", help="row-partition over the ranks torchrun started, or a world of one")
    s.add_argument("--out", help="save solution + info (.npz)")
    s.add_argument("--quiet", action="store_true")
    s.set_defaults(fn=_cmd_solve)

    i = sub.add_parser("info", help="analyze a matrix / container choice")
    _add_common_args(i)
    i.set_defaults(fn=_cmd_info)
    return p


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
