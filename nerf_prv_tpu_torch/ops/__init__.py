"""Hand-written CUDA kernels (``csrc/``), each beside its plain version."""

from .frames_u8 import frames_to_u8, frames_to_u8_plain
from .fused import encode_fused
from .hash_encode import hash_encode, hash_encode_backward
from .row_gather import row_gather, row_gather_plain
from .row_scatter_add import row_scatter_add, row_scatter_add_plain
from .sorted_grad import encode_sorted, segmented_scatter_add, table_grad_sorted

__all__ = [
    "encode_fused", "encode_sorted", "frames_to_u8", "frames_to_u8_plain", "hash_encode", "hash_encode_backward",
    "row_gather", "row_gather_plain",
    "row_scatter_add", "row_scatter_add_plain",
    "segmented_scatter_add", "table_grad_sorted",
]
