"""PRVNet inference: view-budget prediction, in PyTorch.

Counterpart of ``nerf_prv_tpu/prvnet/infer.py``: load a checkpoint once,
read the pattern-[0, 1, 3] images, forward PVBNet,
``round(13 + 45 * sigmoid(logit))``.  The checkpoint is the reference's own
``best_checkpoint.pth`` layout (``model_state_dict`` with ``module.``
prefixes) or a state dict of this package's ``PVBNet``; the two share key
names, so no key is converted.

The forward runs cuDNN's convolutions in full float32: the budget is a
rounded integer, and TF32 moves the logit.  The setting is scoped to the
forward (``torch.backends.cudnn.flags``); no global flag changes.
"""

from __future__ import annotations

import os
from typing import Mapping, Optional, Sequence

import numpy as np
import torch

from .data import load_rgb
from .model import IMG_PATTERN, logits_to_budget, make_pvbnet


def _strip_module(state_dict: Mapping) -> dict:
    return {k[7:] if k.startswith("module.") else k: v for k, v in state_dict.items()}


def load_torch_checkpoint(path: str) -> dict:
    """The model state dict of a ``.pth`` checkpoint (``model_state_dict``
    when present, ``module.`` prefixes stripped).  The file is unpickled in
    full, as the reference's trainer wrote it: load only files you trust."""
    obj = torch.load(path, map_location="cpu", weights_only=False)
    if isinstance(obj, Mapping) and "model_state_dict" in obj:
        obj = obj["model_state_dict"]
    return _strip_module(obj)


class BudgetPredictor:
    """Loads a checkpoint once and predicts integer view budgets on
    ``device``."""

    def __init__(
        self,
        checkpoint_path: Optional[str] = None,
        params: Optional[Mapping] = None,
        arch: str = "convnextv2_tiny",
        min_label: int = 13,
        max_label: int = 58,
        pattern: Sequence[int] = tuple(IMG_PATTERN[2]),
        crop: int = 720,
        device="cuda",
    ):
        if params is None:
            if checkpoint_path is None or not os.path.exists(checkpoint_path):
                raise FileNotFoundError(f"PRVNet checkpoint missing: {checkpoint_path}")
            params = load_torch_checkpoint(checkpoint_path)
        elif isinstance(params, Mapping) and "model_state_dict" in params:
            params = params["model_state_dict"]
        self.device = torch.device(device)
        self.model = make_pvbnet(arch)
        self.model.load_state_dict({k: torch.as_tensor(v) for k, v in _strip_module(params).items()})
        self.model.to(self.device).eval()
        self.min_label = min_label
        self.max_label = max_label
        self.pattern = list(pattern)
        self.crop = crop

    @torch.no_grad()
    def logits(self, views: np.ndarray) -> torch.Tensor:
        """views: (K, H, W, 3) float in [0, 1] -> the (1,) logit on the device;
        a single view is duplicated."""
        if views.shape[0] == 1:
            views = np.concatenate([views, views], axis=0)
        x = torch.as_tensor(np.ascontiguousarray(views, np.float32), device=self.device)[None]
        b = torch.backends.cudnn
        with b.flags(enabled=b.enabled, benchmark=b.benchmark, deterministic=b.deterministic,
                     allow_tf32=False):
            return self.model(x)

    def predict_value_from_arrays(self, views: np.ndarray) -> float:
        """The continuous budget ``min + (max - min) * sigmoid(logit)``,
        computed in float32 on the device and read back."""
        return float(logits_to_budget(self.logits(views), self.min_label, self.max_label)[0])

    def predict_from_arrays(self, views: np.ndarray) -> int:
        """The integer budget (numpy's round, half to even)."""
        return int(np.round(self.predict_value_from_arrays(views)))

    def _read(self, paths) -> np.ndarray:
        return np.stack([load_rgb(p, self.crop) for p in paths])

    def predict_from_dir(self, images_dir: str) -> int:
        """Read ``<dir>/<idx>.png`` per the inference pattern."""
        return self.predict_from_arrays(self._read(os.path.join(images_dir, f"{i}.png") for i in self.pattern))

    def coverage_views(self, coverage_dir: str, view_ids: Sequence[int]) -> np.ndarray:
        return self._read(os.path.join(coverage_dir, f"rgbaClip_{i}.png") for i in view_ids)

    def predict_from_coverage(self, coverage_dir: str, view_ids: Sequence[int]) -> int:
        """Read ``rgbaClip_<id>.png`` from a coverage directory (the
        pipeline's init views)."""
        return self.predict_from_arrays(self.coverage_views(coverage_dir, view_ids))


def convert_encoder_state_dict(state_dict: Mapping) -> dict:
    """An encoder-only checkpoint (plain ConvNeXt-V2 or torchvision ResNet
    keys) -> the port encoder's state dict: the keys are already the
    port's, so only values become tensors and BatchNorm's
    ``num_batches_tracked`` counters are dropped."""
    return {
        k: torch.as_tensor(np.asarray(v)) if not isinstance(v, torch.Tensor) else v
        for k, v in state_dict.items()
        if not k.endswith("num_batches_tracked")
    }


def load_pretrained_encoder(model: torch.nn.Module, checkpoint, imagenet: bool) -> torch.nn.Module:
    """Load ``model.encoder`` from a torch checkpoint (the reference's
    pre-training handoff, ``--premodel_file`` / ``--ImageNet``).

    ``imagenet=True``: the checkpoint's ``model`` entry holds plain encoder
    keys.  ``imagenet=False``: a PVBPretrain state dict whose encoder keys
    carry ``module.encoder.`` / ``encoder.`` prefixes; only those keys are
    taken, prefix-stripped.  Strict: the keys must cover the encoder's
    exactly, with equal shapes, or ``ValueError`` names the difference.
    """
    sd = checkpoint.get("model", checkpoint) if isinstance(checkpoint, Mapping) else checkpoint
    if not imagenet:
        stripped = {}
        for k, v in sd.items():
            at = k.find("encoder.")
            if at >= 0:
                stripped[k[at + len("encoder."):]] = v
        sd = stripped
    got = convert_encoder_state_dict(sd)
    want = model.encoder.state_dict()
    missing = sorted(set(want) - set(got))
    unexpected = sorted(set(got) - set(want))
    if missing or unexpected:
        raise ValueError(
            f"encoder checkpoint mismatch: missing={missing[:5]}"
            f"{'...' if len(missing) > 5 else ''} "
            f"unexpected={unexpected[:5]}{'...' if len(unexpected) > 5 else ''}"
        )
    for k, v in want.items():
        if tuple(got[k].shape) != tuple(v.shape):
            raise ValueError(
                f"encoder param {k}: checkpoint shape {tuple(got[k].shape)} != model shape {tuple(v.shape)}"
            )
    model.encoder.load_state_dict(got)
    return model


def load_flax_encoder(model: torch.nn.Module, pretrain_model: torch.nn.Module) -> torch.nn.Module:
    """Copy the encoder of a PVBPretrain model into a PVBNet (both name the
    shared submodule ``encoder``)."""
    model.encoder.load_state_dict(pretrain_model.encoder.state_dict())
    return model
