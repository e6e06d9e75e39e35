from krylov_tpu_torch.sparse.formats import (
    DiaMatrix,
    Operator,
    StencilMatrix,
    as_operator,
    to_device,
)
from krylov_tpu_torch.sparse import convert, fixtures

__all__ = [
    "DiaMatrix",
    "StencilMatrix",
    "Operator",
    "as_operator",
    "to_device",
    "convert",
    "fixtures",
]
