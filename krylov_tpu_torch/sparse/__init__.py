from krylov_tpu_torch.sparse.formats import (
    DenseMatrix,
    DiaMatrix,
    EllMatrix,
    HybMatrix,
    Operator,
    StencilMatrix,
    as_operator,
    to_device,
)
from krylov_tpu_torch.sparse import convert, fixtures, io

__all__ = [
    "DenseMatrix",
    "DiaMatrix",
    "EllMatrix",
    "HybMatrix",
    "StencilMatrix",
    "Operator",
    "as_operator",
    "to_device",
    "convert",
    "fixtures",
    "io",
]
