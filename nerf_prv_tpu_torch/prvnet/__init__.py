"""PRVNet, the view-budget predictor: its encoders, heads, datasets and
inference (``nerf_prv_tpu/prvnet``'s serving half; its trainer is not
ported yet)."""

from .convnextv2 import MODELS, ConvNeXtV2, convnextv2_tiny
from .data import PVBDataset, PVBPretrainDataset, center_crop, load_rgb
from .infer import (
    BudgetPredictor,
    convert_encoder_state_dict,
    load_flax_encoder,
    load_pretrained_encoder,
    load_torch_checkpoint,
)
from .model import (
    IMG_PATTERN,
    PVBNet,
    PVBPretrain,
    logits_to_budget,
    make_pvbnet,
    make_pvbpretrain,
)

__all__ = [
    "MODELS",
    "ConvNeXtV2",
    "convnextv2_tiny",
    "PVBDataset",
    "PVBPretrainDataset",
    "center_crop",
    "load_rgb",
    "BudgetPredictor",
    "convert_encoder_state_dict",
    "load_flax_encoder",
    "load_pretrained_encoder",
    "load_torch_checkpoint",
    "IMG_PATTERN",
    "PVBNet",
    "PVBPretrain",
    "logits_to_budget",
    "make_pvbnet",
    "make_pvbpretrain",
]
