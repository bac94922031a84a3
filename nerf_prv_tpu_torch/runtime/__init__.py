"""Host-side native IO runtime (ctypes over ``csrc/libprv_runtime.so``)."""

from . import native

__all__ = ["native"]
