"""PRVNet training, in PyTorch: AdamW + L1 on sigmoid-rescaled budgets.

Counterpart of ``nerf_prv_tpu/prvnet/train.py``, function for function:
AdamW with base lr 1.5e-4 scaled by batch/256, weight decay only on the
leaves of more than one dimension, L1 (or MSE) between the [13, 58]-rescaled
sigmoid prediction and the label, per-epoch validation (exact-match accuracy
and L1 distance ± std), the best checkpoint kept and auto-resumed,
``accum_steps`` micro-batches averaged into one application (optax's
``MultiSteps``), and a device-resident data path.

Checkpoints are the JAX package's: ``{"params": <Flax tree>, "meta": {...}}``
in Flax's msgpack (``best_checkpoint.msgpack``), written and read by the
package's own msgpack code (``_msgpack.py``) through
``convert.prvnet_state_dict_to_flax`` / ``_from_flax``, so a file written by
either package loads in the other.  Only parameters cross: neither side
stores optimizer state, and a resumed run restarts the optimizer.

Forward and backward run in float32 with cuDNN's TF32 off, scoped to each
step as ``BudgetPredictor`` scopes its forward (PyTorch's matmul TF32 flag
is off by default and stays so), so the trainer and the predictor compute
the same function.

The trainer takes a port :class:`~..parallel.mesh.Mesh` of one device
(``cuda:0`` unless the caller passes ``devices=["cpu"]``).  The JAX
trainer's ``dp`` axis all-reduces gradients over every device; here that
needs ``torch.distributed`` (ROADMAP.md, the multi-card item), so a mesh of
more than one device raises.
"""

from __future__ import annotations

import json
import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..convert import prvnet_state_dict_from_flax, prvnet_state_dict_to_flax
from ..parallel.mesh import Mesh, make_mesh
from . import _msgpack
from .data import PVBDataset, PVBPretrainDataset, resident_arrays
from .model import IMG_PATTERN, logits_to_budget, make_pvbnet, make_pvbpretrain


@dataclass
class TrainConfig:
    arch: str = "convnextv2_tiny"
    batch_size: int = 64
    blr: float = 1.5e-4
    weight_decay: float = 0.05
    epochs: int = 800
    loss_type: str = "L1"       # ≙ --loss_type L1 default path
    warmup_epochs: int = 40     # ≙ --warmup_epochs
    min_lr: float = 0.0         # ≙ --min_lr default (train_regression.py:446)
    # the reference defines a warmup+cosine schedule but never calls it
    # (train_regression.py:449): it trains at constant args.lr; that is the
    # default, and the schedule is an opt-in
    use_schedule: bool = False
    min_label: int = 13
    max_label: int = 58
    seed: int = 0
    image_size: int = 720
    # gradient accumulation: the optimizer applies once per `accum_steps`
    # micro-batches of size batch_size/accum_steps, so the effective batch
    # (and the blr scaling below) is batch_size.  ConvNeXt-V2 tiny at 720
    # keeps its activations for the backward, which bounds the micro-batch
    # a card holds (PERF.md, smoke-prv-train)
    accum_steps: int = 1
    # device-resident data path: the split is uploaded once as uint8 and
    # each micro-batch is gathered and normalized on the device.  Falls back
    # to streaming when the split exceeds PRV_RESIDENT_MB (default 8192) or
    # micro_batch doesn't divide the mesh
    device_data: bool = True

    @property
    def lr(self) -> float:
        return self.blr * self.batch_size / 256.0  # ≙ train_regression.py:607

    @property
    def micro_batch(self) -> int:
        if self.batch_size % self.accum_steps:
            raise ValueError(
                f"batch_size {self.batch_size} not divisible by "
                f"accum_steps {self.accum_steps}"
            )
        return self.batch_size // self.accum_steps


def _train_micro_batches(ds, cfg: TrainConfig, rng):
    """Micro-batches for one training epoch, accumulation-correct (the JAX
    package's, copied): with ``accum_steps`` k > 1 every micro-batch is full
    and their count per epoch a multiple of k, so that each application
    averages k equal micro-batches; the reshuffle drops another tail each
    epoch."""
    k = cfg.accum_steps
    if k <= 1:
        yield from ds.batches(cfg.micro_batch, rng=rng)
        return
    n_micro = len(ds) // cfg.micro_batch
    n_keep = (n_micro // k) * k
    if n_keep == 0:
        raise ValueError(
            f"dataset of {len(ds)} samples cannot fill one effective batch "
            f"({k} x micro {cfg.micro_batch}); lower batch_size/accum_steps"
        )
    for i, batch in enumerate(ds.batches(cfg.micro_batch, rng=rng, drop_last=True)):
        if i >= n_keep:
            break
        yield batch


def _resident_epoch_indices(n: int, cfg: TrainConfig, rng: np.random.Generator) -> np.ndarray:
    """Shuffled (n_groups, accum_steps, micro_batch) index array, with the
    truncation of :func:`_train_micro_batches` (the JAX package's, copied:
    the same ``rng`` gives the same order)."""
    k = cfg.accum_steps
    micro = cfg.micro_batch
    n_micro = n // micro
    n_keep = (n_micro // k) * k if k > 1 else n_micro
    if n_keep == 0:
        raise ValueError(
            f"dataset of {n} samples cannot fill one effective batch "
            f"({k} x micro {micro}); lower batch_size/accum_steps"
        )
    order = rng.permutation(n)[: n_keep * micro]
    return order.reshape(n_keep // k if k > 1 else n_keep, max(k, 1), micro)


def _wd_mask(model: torch.nn.Module) -> Dict[str, bool]:
    """Decay where the Flax leaf has more than one dimension (≙
    add_weight_decay): every kernel, GRN's (1, 1, 1, C) gamma and beta; not
    biases, LayerNorm or FrozenBN parameters.  Each port tensor has its Flax
    leaf's rank (OIHW against HWIO, transposed Linear weights), so the rank
    is read here."""
    return {name: p.ndim > 1 for name, p in model.named_parameters()}


def warmup_cosine_decay_schedule(
    init_value: float, peak_value: float, warmup_steps: int, decay_steps: int, end_value: float
) -> Callable[[int], float]:
    """``optax.warmup_cosine_decay_schedule`` (exponent 1) as a function of
    the application count: linear from ``init_value`` to ``peak_value`` over
    ``warmup_steps``, then a cosine to ``end_value`` at ``decay_steps``."""
    alpha = 0.0 if peak_value == 0.0 else end_value / peak_value
    span = decay_steps - warmup_steps

    def schedule(count: int) -> float:
        if count < warmup_steps:
            frac = 1.0 - min(max(count, 0), warmup_steps) / warmup_steps
            return (init_value - peak_value) * frac + peak_value
        c = min(count - warmup_steps, span)
        return peak_value * ((1 - alpha) * 0.5 * (1 + math.cos(math.pi * c / span)) + alpha)

    return schedule


def make_optimizer(
    cfg: TrainConfig, model: torch.nn.Module, steps_per_epoch: Optional[int] = None
) -> Tuple[torch.optim.AdamW, Optional[Callable[[int], float]]]:
    """``optax.adamw(b1=0.9, b2=0.999, eps=1e-8)`` with the decay mask as two
    parameter groups, at constant ``cfg.lr`` (the reference's behavior);
    ``cfg.use_schedule`` with ``steps_per_epoch`` returns the warmup+cosine
    schedule as well, which the caller sets as each application's lr (the
    count starts at 0, so the first application runs at lr 0)."""
    mask = _wd_mask(model)
    named = list(model.named_parameters())
    opt = torch.optim.AdamW(
        [
            {"params": [p for n, p in named if mask[n]], "weight_decay": cfg.weight_decay},
            {"params": [p for n, p in named if not mask[n]], "weight_decay": 0.0},
        ],
        lr=cfg.lr,
        betas=(0.9, 0.999),
        eps=1e-8,
    )
    if not (cfg.use_schedule and steps_per_epoch):
        return opt, None
    total = max(cfg.epochs * steps_per_epoch, 2)
    # the cosine segment (decay_steps - warmup_steps) must be non-empty
    warmup = min(cfg.warmup_epochs * steps_per_epoch, total - 1)
    return opt, warmup_cosine_decay_schedule(0.0, cfg.lr, max(warmup, 1), total, cfg.min_lr)


def _init_like_flax(model: torch.nn.Module, generator: torch.Generator) -> None:
    """Draw every convolution and linear layer as the Flax modules do:
    ConvNeXt-V2's at truncated normal σ = 0.02 (its head 0.02 · 0.001),
    ResNet's and the heads' fc layers at LeCun normal; biases zero.  Norms
    and GRN keep their constructors' ones and zeros."""
    from .convnextv2 import ConvNeXtV2

    convnext = isinstance(model.encoder, ConvNeXtV2)
    for name, m in model.named_modules():
        if not isinstance(m, (torch.nn.Conv2d, torch.nn.Linear)):
            continue
        if convnext and name.startswith("encoder."):
            std = 0.02 * (0.001 if name == "encoder.head" else 1.0)
        else:  # variance_scaling(1, fan_in, truncated_normal)
            std = math.sqrt(1.0 / m.weight[0].numel()) / 0.87962566103423978
        with torch.no_grad():
            torch.nn.init.trunc_normal_(m.weight, std=std, a=-2 * std, b=2 * std, generator=generator)
            if m.bias is not None:
                m.bias.zero_()


def init_model(cfg: TrainConfig, n_views: int, image_size: Optional[int] = None) -> torch.nn.Module:
    """A PVBNet of ``cfg.arch``, drawn from a ``torch.Generator`` seeded
    with ``cfg.seed``.  ``n_views`` and ``image_size`` are the JAX
    signature's (Flax takes its shapes from a dummy input); the torch
    modules' shapes depend on neither."""
    model = make_pvbnet(cfg.arch)
    _init_like_flax(model, torch.Generator().manual_seed(cfg.seed))
    return model


def _f32():
    """cuDNN's convolutions in full float32, scoped (no global flag changes)."""
    b = torch.backends.cudnn
    return b.flags(enabled=b.enabled, benchmark=b.benchmark, deterministic=b.deterministic, allow_tf32=False)


def _abs(d: torch.Tensor) -> torch.Tensor:
    """|d| with JAX's gradient: 1 at 0 (``torch.abs`` gives 0 there)."""
    return torch.where(d >= 0, d, -d)


def loss_fn(model: torch.nn.Module, views: torch.Tensor, labels: torch.Tensor, cfg: TrainConfig) -> torch.Tensor:
    pred = logits_to_budget(model(views), cfg.min_label, cfg.max_label)
    d = pred - labels
    if cfg.loss_type == "MSE":
        return torch.mean(d * d)
    return torch.mean(_abs(d))


def _accumulate(acc: List[torch.Tensor], grads, n_acc: int) -> List[torch.Tensor]:
    """``MultiSteps``' running mean after ``n_acc`` earlier micro-gradients
    (Welford: acc + (g - acc) / (n_acc + 1))."""
    diff = torch._foreach_sub(list(grads), acc)
    torch._foreach_div_(diff, float(n_acc + 1))
    torch._foreach_add_(acc, diff)
    return acc


def _mesh_device(mesh: Optional[Mesh]) -> torch.device:
    mesh = mesh if mesh is not None else make_mesh()
    if mesh.size != 1:
        raise NotImplementedError(
            f"PRVNet training on a mesh of {mesh.size} devices needs the dp gradient all-reduce over "
            "torch.distributed (ROADMAP.md §1, the multi-card item); pass a mesh of one device"
        )
    return torch.device(mesh.devices.flat[0])


class _TrainStep:
    """One micro-step a call: the loss and its gradients, folded into the
    running mean; every ``accum_steps``-th call applies AdamW to the mean
    (at the schedule's lr for this application's count, where there is
    one).  Returns the micro-batch's loss, left on the device."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: Optional[int], device):
        self.model, self.cfg, self.device = model, cfg, device
        self.params = list(model.parameters())
        self.opt, self.schedule = make_optimizer(cfg, model, steps_per_epoch)
        self.acc: Optional[List[torch.Tensor]] = None
        self.mini = 0
        self.count = 0

    def __call__(self, views, labels) -> torch.Tensor:
        views = torch.as_tensor(views, device=self.device)
        labels = torch.as_tensor(labels, device=self.device)
        self.model.train()
        with _f32():
            loss = loss_fn(self.model, views, labels, self.cfg)
            grads = torch.autograd.grad(loss, self.params)
        self.acc = list(grads) if self.mini == 0 else _accumulate(self.acc, grads, self.mini)
        self.mini += 1
        if self.mini == self.cfg.accum_steps:
            for p, g in zip(self.params, self.acc):
                p.grad = g
            if self.schedule is not None:
                for group in self.opt.param_groups:
                    group["lr"] = self.schedule(self.count)
            self.opt.step()
            self.opt.zero_grad(set_to_none=True)
            self.acc, self.mini = None, 0
            self.count += 1
        return loss.detach()


def make_train_step(model: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: Optional[int] = None,
                    mesh: Optional[Mesh] = None) -> _TrainStep:
    """``step(views, labels) -> loss``: one micro-step on the mesh's device
    (≙ ``make_train_step`` with the ``MultiSteps``-wrapped optimizer)."""
    return _TrainStep(model, cfg, steps_per_epoch, _mesh_device(mesh))


def make_eval_step(model: torch.nn.Module, cfg: TrainConfig, mesh: Optional[Mesh] = None):
    """``predict(views) -> budgets`` on the mesh's device, float32."""
    device = _mesh_device(mesh)

    @torch.no_grad()
    def predict(views) -> torch.Tensor:
        model.eval()
        with _f32():
            logits = model(torch.as_tensor(views, device=device))
        return logits_to_budget(logits, cfg.min_label, cfg.max_label)

    return predict


def _use_resident(cfg: TrainConfig, ds, n_views: int, mesh: Mesh) -> bool:
    """Device-resident eligibility: the split fits PRV_RESIDENT_MB and the
    micro-batch splits evenly over the mesh."""
    if not cfg.device_data:
        return False
    budget_mb = float(os.environ.get("PRV_RESIDENT_MB", "8192"))
    nbytes = len(ds) * n_views * cfg.image_size * cfg.image_size * 3
    return nbytes <= budget_mb * 2**20 and cfg.micro_batch % mesh.size == 0


def _metrics(preds: np.ndarray, labels: np.ndarray) -> Dict[str, float]:
    n = len(labels)
    dists = np.abs(preds - labels)
    return {
        "accuracy": float((np.round(preds) == labels).mean()) if n else 0.0,
        "l1_mean": float(dists.mean()) if n else 0.0,
        "l1_std": float(dists.std()) if n else 0.0,
    }


def _resident_metrics(predict, imgs_dev: torch.Tensor, labels: np.ndarray, micro: int) -> Dict[str, float]:
    """check_accuracy over a device-resident split (the same metrics)."""
    preds = [predict(imgs_dev[s:s + micro].float() / 255.0) for s in range(0, len(labels), micro)]
    preds = torch.cat(preds).cpu().numpy() if preds else np.zeros(0, np.float32)
    return _metrics(preds, labels)


def check_accuracy(predict, dataset, cfg: TrainConfig) -> Dict[str, float]:
    """≙ check_accuracy (train_regression.py:340-432): exact rounded-match
    accuracy plus L1 distance mean ± std, in micro-batches.  ``predict`` is
    :func:`make_eval_step`'s (the model holds its parameters, which the JAX
    function takes apart)."""
    dists, correct, total = [], 0, 0
    for views, labels in dataset.batches(cfg.micro_batch):
        pred = predict(views).cpu().numpy()
        correct += int((np.round(pred) == labels).sum())
        total += len(labels)
        dists.extend(np.abs(pred - labels).tolist())
    dists = np.asarray(dists) if dists else np.zeros(1)
    return {
        "accuracy": correct / max(total, 1),
        "l1_mean": float(dists.mean()),
        "l1_std": float(dists.std()),
    }


def save_checkpoint(path: str, params, meta: Optional[dict] = None) -> None:
    """Write ``{"params": <Flax tree>, "meta": meta}`` as Flax's msgpack;
    ``params`` is a PVBNet / PVBPretrain module or its state dict."""
    if isinstance(params, torch.nn.Module):
        params = params.state_dict()
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    blob = _msgpack.serialize({"params": prvnet_state_dict_to_flax(params), "meta": meta or {}})
    with open(path, "wb") as f:
        f.write(blob)


def load_checkpoint(path: str) -> Tuple[dict, dict]:
    """(the Flax param tree as numpy arrays, meta) of a ``.msgpack``
    checkpoint written by either package."""
    with open(path, "rb") as f:
        obj = _msgpack.restore(f.read())
    return obj["params"], obj.get("meta", {})


def _load_params(model: torch.nn.Module, flax_params: Mapping) -> None:
    model.load_state_dict(prvnet_state_dict_from_flax(flax_params))


def _fit(model, train_ds, val_ds, n_views: int, cfg: TrainConfig, mesh: Mesh, steps_per_epoch: int,
         best: dict, best_path: str, log_path: str, tag: str, log_every: int):
    """The epoch loop both trainers share: train (resident or streaming),
    validate, log a line to ``log_path``, keep the best checkpoint."""
    device = _mesh_device(mesh)
    model.to(device)
    step = make_train_step(model, cfg, steps_per_epoch, mesh)
    predict = make_eval_step(model, cfg, mesh)
    resident = _use_resident(cfg, train_ds, n_views, mesh)
    if resident:
        t_imgs, t_labels = (torch.from_numpy(a).to(device) for a in resident_arrays(train_ds))
        if val_ds is train_ds:
            v_imgs, v_labels = t_imgs, t_labels.cpu().numpy()
        else:
            v_imgs, v_labels = resident_arrays(val_ds)
            v_imgs = torch.from_numpy(v_imgs).to(device)
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(os.path.dirname(best_path) or ".", exist_ok=True)
    for epoch in range(cfg.epochs):
        if resident:
            parts = []
            for grp in _resident_epoch_indices(len(train_ds), cfg, rng):
                for row in torch.from_numpy(grp).to(device):
                    views = t_imgs.index_select(0, row).float() / 255.0
                    parts.append(step(views, t_labels.index_select(0, row)))
            losses = torch.stack(parts).cpu().numpy()
            metrics = _resident_metrics(predict, v_imgs, v_labels, cfg.micro_batch)
        else:
            parts = [step(views, labels) for views, labels in _train_micro_batches(train_ds, cfg, rng)]
            losses = torch.stack(parts).cpu().tolist()
            metrics = check_accuracy(predict, val_ds, cfg)
        with open(log_path, "a") as f:
            f.write(json.dumps({"epoch": epoch, "train_loss": float(np.mean(losses)), **metrics}) + "\n")
        if epoch % log_every == 0 or epoch == cfg.epochs - 1:
            print(
                f"{tag}epoch {epoch}: loss {np.mean(losses):.4f} "
                f"val acc {metrics['accuracy']:.3f} "
                f"l1 {metrics['l1_mean']:.3f}±{metrics['l1_std']:.3f}"
            )
        # min-delta 0.01, as the JAX trainer: no resave for float-noise gains
        if metrics["l1_mean"] < best.get("l1_mean", float("inf")) - 0.01:
            best = metrics
            save_checkpoint(best_path, model, {"val": metrics, "epoch": epoch})
    return model, best


def train_regression(
    dataset_root: str,
    train_split: str,
    val_split: str,
    cfg: Optional[TrainConfig] = None,
    pattern=None,
    checkpoint_dir: str = "checkpoints",
    log_every: int = 10,
    mesh: Optional[Mesh] = None,
    premodel_file: Optional[str] = None,
    imagenet: bool = False,
) -> Tuple[torch.nn.Module, Dict[str, float]]:
    """Full trainer (≙ main(), train_regression.py:478-683).

    Returns (the trained PVBNet on the mesh's device, best val metrics).
    ``checkpoint_dir`` receives ``best_checkpoint.msgpack`` and
    ``log.jsonl``; an existing best checkpoint is auto-resumed (≙
    --auto_resume).  ``premodel_file`` initializes the encoder (≙
    ``--premodel_file`` / ``--ImageNet``): a ``.msgpack`` path is a
    :func:`pretrain` checkpoint of either package, anything else is
    torch-loaded (``imagenet=True`` for an official ImageNet ConvNeXt-V2
    checkpoint, ``False`` for an ``encoder.``-prefixed PVB checkpoint).
    """
    from .infer import load_flax_encoder, load_pretrained_encoder

    cfg = cfg or TrainConfig()
    pattern = pattern if pattern is not None else IMG_PATTERN[4]
    mesh = mesh if mesh is not None else make_mesh()
    _mesh_device(mesh)

    train_ds = PVBDataset(dataset_root, train_split, pattern, crop=cfg.image_size)
    val_ds = PVBDataset(dataset_root, val_split, pattern, crop=cfg.image_size)

    model = init_model(cfg, len(pattern))
    best_path = os.path.join(checkpoint_dir, "best_checkpoint.msgpack")
    best = {"accuracy": -1.0, "l1_mean": float("inf")}
    if os.path.exists(best_path):  # auto-resume (≙ utils.auto_load_model)
        params, meta = load_checkpoint(best_path)
        _load_params(model, params)
        best = meta.get("val", best)
    elif premodel_file:
        if premodel_file.endswith(".msgpack"):
            pre = make_pvbpretrain(cfg.arch)
            pre.encoder.load_state_dict(prvnet_state_dict_from_flax(load_checkpoint(premodel_file)[0]["encoder"]))
            load_flax_encoder(model, pre)
        else:
            ckpt = torch.load(premodel_file, map_location="cpu", weights_only=False)
            load_pretrained_encoder(model, ckpt, imagenet)

    steps_per_epoch = max(-(-len(train_ds.names) // cfg.batch_size), 1)
    return _fit(model, train_ds, val_ds, len(pattern), cfg, mesh, steps_per_epoch, best, best_path,
                os.path.join(checkpoint_dir, "log.jsonl"), "", log_every)


def pretrain(
    dataset_root: str,
    train_split: str,
    val_split: Optional[str] = None,
    cfg: Optional[TrainConfig] = None,
    checkpoint_dir: str = "checkpoints",
    log_every: int = 10,
    mesh: Optional[Mesh] = None,
    viewspace_size: int = 64,
) -> Tuple[torch.nn.Module, Dict[str, float]]:
    """Single-view PVBPretrain stage (≙ ``--pre_train``,
    train_regression.py:23,50-65,101-167,578-581): each of the coverage
    views is an independent (image, budget) sample under the same loss.  The
    checkpoint's encoder seeds :func:`train_regression` through
    ``premodel_file``.

    Writes ``best_pretrain_checkpoint.msgpack`` and ``pretrain_log.jsonl``;
    returns (the trained PVBPretrain, best val metrics); val falls back to
    the train split when no ``val_split`` is given.
    """
    cfg = cfg or TrainConfig()
    mesh = mesh if mesh is not None else make_mesh()
    _mesh_device(mesh)

    train_ds = PVBPretrainDataset(dataset_root, train_split, viewspace_size=viewspace_size, crop=cfg.image_size)
    val_ds = (
        PVBPretrainDataset(dataset_root, val_split, viewspace_size=viewspace_size, crop=cfg.image_size)
        if val_split
        else train_ds
    )

    model = make_pvbpretrain(cfg.arch)
    _init_like_flax(model, torch.Generator().manual_seed(cfg.seed))
    best_path = os.path.join(checkpoint_dir, "best_pretrain_checkpoint.msgpack")
    best = {"accuracy": -1.0, "l1_mean": float("inf")}
    if os.path.exists(best_path):  # auto-resume (≙ utils.auto_load_model)
        params, meta = load_checkpoint(best_path)
        _load_params(model, params)
        best = meta.get("val", best)

    steps_per_epoch = max(-(-len(train_ds) // cfg.batch_size), 1)
    return _fit(model, train_ds, val_ds, 1, cfg, mesh, steps_per_epoch, best, best_path,
                os.path.join(checkpoint_dir, "pretrain_log.jsonl"), "pretrain ", log_every)
