"""Carry field parameters between the JAX package and the port.

Both sides keep parameters as flat dicts under the same key names
(``grid`` for the voxel field or ``table`` for the hash field, then
``sigma_w0``, ``sigma_w1``, ``color_w0``, ``color_w1``, ``color_w2``), and
both write them as the same npz snapshot (``nerf/api.py``
``save_snapshot``), so conversion is a dtype-preserving copy between numpy
arrays and tensors.  Only parameters cross: a snapshot carries no
optimizer state on either side.

A batched parameter tree (K objects' parameters stacked on a leading
axis: the reference's ``vmap``-ed ``init_params`` and ``train_batch``, the
port's ``nerf/batch_train.py``) crosses the same way, leading axis kept;
either side's ``slice_params`` then gives object i's tree as that side's
``eval_nerf`` and ``save_snapshot`` take it.

PRVNet's parameters cross differently: the JAX package keeps a nested Flax
tree (``encoder/stage0_block0/dwconv/kernel``, HWIO convs, ``(in, out)``
Dense kernels), the port the official ConvNeXt-V2 / torchvision state dict
(``encoder.stages.0.0.dwconv.weight``, OIHW convs, ``(out, in)`` Linear
weights).  :func:`prvnet_state_dict_from_flax` maps the first to the
second, and :func:`prvnet_state_dict_to_flax` is its exact inverse (the
JAX package's ``convert_torch_checkpoint`` computes the same inverse for
the ConvNeXt-V2 keys).
"""

from __future__ import annotations

import os
import re
from typing import Dict, List, Mapping, Tuple, Union

import numpy as np
import torch


def params_from_numpy(
    d: Union[Mapping[str, np.ndarray], str, os.PathLike], device="cuda"
) -> Dict[str, torch.Tensor]:
    """Numpy arrays (``np.asarray`` of a JAX parameter tree, batched or
    not), or the path of an npz snapshot, -> the port's tensors on
    ``device``."""
    if isinstance(d, (str, os.PathLike)):
        with np.load(d) as z:
            d = {k: z[k] for k in z.files}
    return {k: torch.from_numpy(np.array(v)).to(device) for k, v in d.items()}


def params_to_numpy(params: Mapping[str, torch.Tensor]) -> Dict[str, np.ndarray]:
    """The port's tensors -> host numpy arrays (``jnp.asarray`` takes them)."""
    return {k: v.detach().cpu().numpy() for k, v in params.items()}


# (Flax path, torch key, kind): ``{a}``, ``{b}``, ``{c}`` stand for decimal
# indices; kind "conv" is an HWIO <-> OIHW kernel, "dense" a transposed
# matrix, "" a copy
_BN = (("scale", "weight"), ("bias", "bias"), ("mean", "running_mean"), ("var", "running_var"))
_PRVNET_KEYS: List[Tuple[str, str, str]] = [
    ("stem_conv/kernel", "downsample_layers.0.0.weight", "conv"),
    ("stem_conv/bias", "downsample_layers.0.0.bias", ""),
    ("stem_norm/scale", "downsample_layers.0.1.weight", ""),
    ("stem_norm/bias", "downsample_layers.0.1.bias", ""),
    ("downsample_norm{a}/scale", "downsample_layers.{a}.0.weight", ""),
    ("downsample_norm{a}/bias", "downsample_layers.{a}.0.bias", ""),
    ("downsample_conv{a}/kernel", "downsample_layers.{a}.1.weight", "conv"),
    ("downsample_conv{a}/bias", "downsample_layers.{a}.1.bias", ""),
    ("stage{a}_block{b}/dwconv/kernel", "stages.{a}.{b}.dwconv.weight", "conv"),
    ("stage{a}_block{b}/dwconv/bias", "stages.{a}.{b}.dwconv.bias", ""),
    ("stage{a}_block{b}/norm/scale", "stages.{a}.{b}.norm.weight", ""),
    ("stage{a}_block{b}/norm/bias", "stages.{a}.{b}.norm.bias", ""),
    ("stage{a}_block{b}/pwconv1/kernel", "stages.{a}.{b}.pwconv1.weight", "dense"),
    ("stage{a}_block{b}/pwconv1/bias", "stages.{a}.{b}.pwconv1.bias", ""),
    ("stage{a}_block{b}/pwconv2/kernel", "stages.{a}.{b}.pwconv2.weight", "dense"),
    ("stage{a}_block{b}/pwconv2/bias", "stages.{a}.{b}.pwconv2.bias", ""),
    ("stage{a}_block{b}/grn/gamma", "stages.{a}.{b}.grn.gamma", ""),
    ("stage{a}_block{b}/grn/beta", "stages.{a}.{b}.grn.beta", ""),
    ("head_norm/scale", "norm.weight", ""),
    ("head_norm/bias", "norm.bias", ""),
    ("head/kernel", "head.weight", "dense"),
    ("head/bias", "head.bias", ""),
    # torchvision ResNet
    ("conv1/kernel", "conv1.weight", "conv"),
    ("layer{a}_block{b}/conv{c}/kernel", "layer{a}.{b}.conv{c}.weight", "conv"),
    ("layer{a}_block{b}/down_conv/kernel", "layer{a}.{b}.downsample.0.weight", "conv"),
    ("fc/kernel", "fc.weight", "dense"),
    ("fc/bias", "fc.bias", ""),
] + [
    row
    for f, t in _BN
    for row in (
        (f"bn1/{f}", f"bn1.{t}", ""),
        (f"layer{{a}}_block{{b}}/bn{{c}}/{f}", f"layer{{a}}.{{b}}.bn{{c}}.{t}", ""),
        (f"layer{{a}}_block{{b}}/down_bn/{f}", f"layer{{a}}.{{b}}.downsample.1.{t}", ""),
    )
]


def _pattern(template: str) -> "re.Pattern":
    parts = re.split(r"\{([abc])\}", template)
    return re.compile("".join(re.escape(p) if i % 2 == 0 else f"(?P<{p}>\\d+)" for i, p in enumerate(parts)))


_FLAX_TO_TORCH = [(_pattern(f), t, kind) for f, t, kind in _PRVNET_KEYS]
_TORCH_TO_FLAX = [(_pattern(t), f, kind) for f, t, kind in _PRVNET_KEYS]


def _map_key(key: str, table) -> Tuple[str, str]:
    for pat, template, kind in table:
        m = pat.fullmatch(key)
        if m:
            return template.format(**m.groupdict()), kind
    raise KeyError(f"no PRVNet parameter maps {key!r}")


def _flatten(tree, prefix=()):
    if isinstance(tree, Mapping):
        for k, v in tree.items():
            yield from _flatten(v, prefix + (k,))
    else:
        yield prefix, tree


def _encoder_to_torch(tree, prefix: str, out: dict) -> None:
    for path, leaf in _flatten(tree):
        key, kind = _map_key("/".join(path), _FLAX_TO_TORCH)
        v = np.asarray(leaf)
        if kind == "conv":
            v = v.transpose(3, 2, 0, 1)
        elif kind == "dense":
            v = v.T
        out[prefix + key] = torch.from_numpy(np.array(v))


def prvnet_state_dict_from_flax(tree: Mapping) -> Dict[str, torch.Tensor]:
    """A Flax PVBNet or PVBPretrain param tree (``{"encoder": ..., "fc{i}":
    ...}``), or an encoder's tree alone, as numpy arrays -> the port's
    state dict (CPU tensors, the official key names)."""
    out: Dict[str, torch.Tensor] = {}
    if "encoder" not in tree:
        _encoder_to_torch(tree, "", out)
        return out
    _encoder_to_torch(tree["encoder"], "encoder.", out)
    for name, leaf in tree.items():
        m = re.fullmatch(r"fc(\d+)", name)
        if m is None:
            if name != "encoder":
                raise KeyError(f"no PRVNet parameter maps {name!r}")
            continue
        out[f"fc_layer.{m.group(1)}.weight"] = torch.from_numpy(np.array(np.asarray(leaf["kernel"]).T))
        out[f"fc_layer.{m.group(1)}.bias"] = torch.from_numpy(np.array(leaf["bias"]))
    return out


def prvnet_state_dict_to_flax(state_dict: Mapping) -> dict:
    """The inverse of :func:`prvnet_state_dict_from_flax`: the port's (or
    the reference's ``.pth``) state dict -> the Flax tree as numpy arrays;
    ``module.`` prefixes are stripped, BatchNorm counters dropped."""
    tree: dict = {}

    def put(path, v):
        node = tree
        for k in path[:-1]:
            node = node.setdefault(k, {})
        node[path[-1]] = v

    for key, value in state_dict.items():
        key = key[7:] if key.startswith("module.") else key
        if key.endswith("num_batches_tracked"):
            continue
        v = value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)
        m = re.fullmatch(r"fc_layer\.(\d+)\.(weight|bias)", key)
        if m:
            put((f"fc{m.group(1)}", "kernel" if m.group(2) == "weight" else "bias"),
                v.T if m.group(2) == "weight" else v)
            continue
        prefix = ()
        if key.startswith("encoder."):
            key, prefix = key[len("encoder."):], ("encoder",)
        path, kind = _map_key(key, _TORCH_TO_FLAX)
        if kind == "conv":
            v = v.transpose(2, 3, 1, 0)
        elif kind == "dense":
            v = v.T
        put(prefix + tuple(path.split("/")), np.ascontiguousarray(v))
    return tree
