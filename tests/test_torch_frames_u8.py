"""The training frames' quantisation to uint8 (``ops/frames_u8.py``): its
plain version byte-equal to the numpy formula the JAX package uses, and the
wrapper's argument checks, on the CPU.  ``tests/test_torch_cuda_kernels.py``
holds the card's kernel to the same values."""

import numpy as np
import pytest
import torch

from nerf_prv_tpu_torch.ops.frames_u8 import frames_to_u8, frames_to_u8_plain

_K = np.arange(256, dtype=np.float64)
_HALVES = ((_K + 0.5) / 255).astype(np.float32)

# the values where rounding decides the byte: every level, every point half
# way between two levels with its two float32 neighbours, and values at and
# beyond the range's ends
EDGE_VALUES = {
    "levels": (_K / 255).astype(np.float32),
    "halves": np.concatenate([np.nextafter(_HALVES, np.float32(-1)), _HALVES, np.nextafter(_HALVES, np.float32(2))]),
    "ends": np.array([0.0, 1.0, -0.0, -1e-8, 1 + 1e-7, 2.0, -3.0], np.float32),
}


def numpy_u8(x: np.ndarray) -> np.ndarray:
    """The definition: ``stack_datasets``' numpy formula on float32 frames."""
    return np.clip(x * 255.0 + 0.5, 0, 255).astype(np.uint8)


def as_frames(values: np.ndarray) -> np.ndarray:
    """``values`` as a (1, 1, W, 4) float32 frame, zero-padded to whole pixels."""
    flat = np.zeros(-(-values.size // 4) * 4, np.float32)
    flat[: values.size] = values
    return flat.reshape(1, 1, -1, 4)


@pytest.mark.parametrize("case", list(EDGE_VALUES))
def test_frames_to_u8_plain_equals_numpy(case):
    x = EDGE_VALUES[case]
    assert x.dtype == np.float32
    want = numpy_u8(x)
    np.testing.assert_array_equal(frames_to_u8_plain(torch.from_numpy(x)).numpy(), want)
    frames = as_frames(x)
    out = torch.full(frames.shape, 7, dtype=torch.uint8)
    assert frames_to_u8(torch.from_numpy(frames), out) is out
    np.testing.assert_array_equal(out.numpy(), numpy_u8(frames))


@pytest.mark.parametrize("case", ["float64", "uint8_out_int32", "not_rgba", "shapes_differ", "not_contiguous"])
def test_frames_to_u8_rejects_what_it_does_not_take(case):
    src = torch.rand((2, 3, 5, 4))
    out = torch.empty((2, 3, 5, 4), dtype=torch.uint8)
    if case == "float64":
        src = src.double()
    elif case == "uint8_out_int32":
        out = out.int()
    elif case == "not_rgba":
        src, out = src[..., :3].contiguous(), out[..., :3].contiguous()
    elif case == "shapes_differ":
        out = out[:1]
    else:
        src = src.transpose(1, 2).contiguous().transpose(1, 2)
    with pytest.raises(ValueError):
        frames_to_u8(src, out)


def test_frames_to_u8_empty_source_leaves_the_destination():
    out = torch.empty((0, 3, 5, 4), dtype=torch.uint8)
    assert frames_to_u8(torch.empty((0, 3, 5, 4)), out) is out
