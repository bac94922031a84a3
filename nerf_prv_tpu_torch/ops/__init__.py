"""Hand-written CUDA kernels (``csrc/``), each beside its plain version."""

from .fused import encode_fused
from .hash_encode import hash_encode

__all__ = ["encode_fused", "hash_encode"]
