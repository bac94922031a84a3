"""Hand-written CUDA kernels (``csrc/``), each beside its plain version."""

from .fused import encode_fused
from .hash_encode import hash_encode
from .row_gather import row_gather, row_gather_plain
from .row_scatter_add import row_scatter_add, row_scatter_add_plain

__all__ = [
    "encode_fused", "hash_encode",
    "row_gather", "row_gather_plain",
    "row_scatter_add", "row_scatter_add_plain",
]
