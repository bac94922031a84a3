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

The trainer takes a port :class:`~..parallel.mesh.Mesh` (every card by
default; ``devices=["cpu"]`` for the CPU) and trains data-parallel over its
``dp`` devices, as the JAX trainer's ``jit(in_shardings=(rep, rep, bs,
bs))`` does: the master model lives on the first device and a replica on
each other distinct device (a device listed twice shares its tensors),
refreshed after each AdamW application; each micro-batch is split over the
devices, each runs forward and loss on its share, and the global mean
Σ (nᵢ/N)·lossᵢ on the first device is differentiated, so the devices'
gradients are summed there (the all-reduce).  The loss is per sample in
both packages (``resnet.py``'s BatchNorm is an affine map over running
statistics, ConvNeXt-V2's GRN is per sample), so a shard computes what the
whole batch computes for its samples.  A micro-batch that does not divide
over the mesh raises, as the JAX ``jit`` does; evaluation pads each batch
to the mesh and drops the padding.
"""

from __future__ import annotations

import copy
import json
import math
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Mapping, Optional, Tuple

import numpy as np
import torch

from ..convert import prvnet_state_dict_from_flax, prvnet_state_dict_to_flax
from ..parallel.mesh import Mesh, _axis_devices, make_mesh, pad_to_multiple, shard_batch
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


def _concrete(d: torch.device) -> torch.device:
    """``cuda`` as the card a tensor moved there lands on."""
    return torch.device("cuda", torch.cuda.current_device()) if d.type == "cuda" and d.index is None else d


class _Replicas:
    """The model on each distinct device along the mesh's ``dp`` axis: the
    master (the model itself, moved to the first device) and a copy on
    every other device, whose weights :meth:`refresh` sets to the master's."""

    def __init__(self, model: torch.nn.Module, mesh: Optional[Mesh]):
        mesh = mesh if mesh is not None else make_mesh()
        self.devices = [_concrete(d) for d in _axis_devices(mesh, "dp")]
        self.mesh = make_mesh(("dp",), devices=self.devices)
        self.first = self.devices[0]
        self.master = model.to(self.first)
        self.models = {self.first: model}
        for d in self.devices:
            if d not in self.models:
                self.models[d] = copy.deepcopy(model).to(d)

    @torch.no_grad()
    def refresh(self) -> None:
        master = list(self.master.parameters())
        for d, m in self.models.items():
            if d != self.first:
                torch._foreach_copy_(list(m.parameters()), [p.to(d) for p in master])

    def shard(self, *arrays) -> list:
        """Split each array's leading axis over the devices: one tuple of
        tensors per device, in mesh order (raises where it does not divide)."""
        return shard_batch(tuple(torch.as_tensor(a) for a in arrays), self.mesh)


class _TrainStep:
    """One micro-step a call: the loss and its gradients, folded into the
    running mean; every ``accum_steps``-th call applies AdamW to the mean
    (at the schedule's lr for this application's count, where there is
    one) and refreshes the replicas.  Returns the micro-batch's loss, left
    on the first device."""

    def __init__(self, model: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: Optional[int], mesh):
        self.replicas = _Replicas(model, mesh)
        self.model, self.cfg, self.device = model, cfg, self.replicas.first
        self.params = list(model.parameters())
        self.opt, self.schedule = make_optimizer(cfg, model, steps_per_epoch)
        self.acc: Optional[List[torch.Tensor]] = None
        self.mini = 0
        self.count = 0

    def loss_and_grads(self, parts) -> Tuple[torch.Tensor, List[torch.Tensor]]:
        """The micro-batch's mean loss and its gradients with respect to the
        master's parameters, from ``parts``: one (views, labels) pair per
        device, each on its device.  Each replica's gradients are summed
        into the master's on the first device."""
        n = sum(int(labels.shape[0]) for _, labels in parts)
        models = list(self.replicas.models.values())
        total = None
        with _f32():
            for views, labels in parts:
                model = self.replicas.models[views.device]
                model.train()
                share = (loss_fn(model, views, labels, self.cfg) * (labels.shape[0] / n)).to(self.device)
                total = share if total is None else total + share
            grads = torch.autograd.grad(total, [p for m in models for p in m.parameters()])
        k = len(self.params)
        summed = list(grads[:k])
        for i in range(k, len(grads), k):
            summed = [a + g.to(self.device) for a, g in zip(summed, grads[i:i + k])]
        return total.detach(), summed

    def __call__(self, views, labels) -> torch.Tensor:
        return self.sharded(self.replicas.shard(views, labels))

    def sharded(self, parts) -> torch.Tensor:
        """A micro-step on a micro-batch already split over the devices."""
        loss, grads = self.loss_and_grads(parts)
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
            self.replicas.refresh()
            self.acc, self.mini = None, 0
            self.count += 1
        return loss


def make_train_step(model: torch.nn.Module, cfg: TrainConfig, steps_per_epoch: Optional[int] = None,
                    mesh: Optional[Mesh] = None) -> _TrainStep:
    """``step(views, labels) -> loss``: one micro-step, data-parallel over
    the mesh's ``dp`` devices (≙ ``make_train_step`` with the
    ``MultiSteps``-wrapped optimizer); the model moves to the first device."""
    return _TrainStep(model, cfg, steps_per_epoch, mesh)


class _Predict:
    """``predict(views) -> budgets`` in float32 over the replicas' devices:
    the batch split over them (it must divide, as for the JAX ``jit``), each
    share run on its device's replica; the budgets land on the first
    device."""

    def __init__(self, replicas: _Replicas, cfg: TrainConfig):
        self.replicas = replicas
        self.cfg = cfg

    def __call__(self, views) -> torch.Tensor:
        return self.sharded(self.replicas.shard(views))

    @torch.no_grad()
    def sharded(self, parts) -> torch.Tensor:
        """Budgets of a batch already split over the devices."""
        out = []
        with _f32():
            for (views,) in parts:
                model = self.replicas.models[views.device]
                model.eval()
                budgets = logits_to_budget(model(views), self.cfg.min_label, self.cfg.max_label)
                out.append(budgets.to(self.replicas.first))
        return torch.cat(out)


def make_eval_step(model: torch.nn.Module, cfg: TrainConfig, mesh: Optional[Mesh] = None) -> _Predict:
    """``predict(views) -> budgets`` over the mesh's ``dp`` devices, float32
    (≙ ``make_eval_step``); the model moves to the first device, and the
    other devices' copies hold its weights as they are now."""
    return _Predict(_Replicas(model, mesh), cfg)


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


def _resident_metrics(predict: _Predict, imgs: Dict[torch.device, torch.Tensor], labels: np.ndarray,
                      micro: int) -> Dict[str, float]:
    """check_accuracy over a device-resident split (the same metrics):
    each batch's indices padded to the mesh with index 0 (≙ the JAX
    version), split over its devices, each share gathered from its device's
    copy, the padding dropped."""
    parts = []
    for s in range(0, len(labels), micro):
        idx, n_real = pad_to_multiple(np.arange(s, min(s + micro, len(labels))), predict.replicas.mesh.size)
        shares = predict.replicas.shard(idx)
        parts.append(predict.sharded([(imgs[i.device].index_select(0, i).float() / 255.0,) for (i,) in shares])[:n_real])
    preds = torch.cat(parts).cpu().numpy() if parts else np.zeros(0, np.float32)
    return _metrics(preds, labels)


def check_accuracy(predict, dataset, cfg: TrainConfig) -> Dict[str, float]:
    """≙ check_accuracy (train_regression.py:340-432): exact rounded-match
    accuracy plus L1 distance mean ± std, in micro-batches, each padded to
    the mesh and cut back.  ``predict`` is :func:`make_eval_step`'s (the
    model holds its parameters, which the JAX function takes apart)."""
    dists, correct, total = [], 0, 0
    for views, labels in dataset.batches(cfg.micro_batch):
        views, n_real = pad_to_multiple(views, predict.replicas.mesh.size)
        pred = predict(views)[:n_real].cpu().numpy()
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
    validate, log a line to ``log_path``, keep the best checkpoint.  The
    model is trained on the mesh's first device (replicated to the others)
    and the losses are read there."""
    step = make_train_step(model, cfg, steps_per_epoch, mesh)
    predict = _Predict(step.replicas, cfg)  # the replicas the step refreshes after each application
    resident = _use_resident(cfg, train_ds, n_views, mesh)
    if resident:
        # the uint8 stacks, copied once onto each distinct device
        devices = step.replicas.models
        train_arrays = resident_arrays(train_ds)
        t_imgs, t_labels = ({d: torch.from_numpy(a).to(d) for d in devices} for a in train_arrays)
        if val_ds is train_ds:
            v_imgs, v_labels = t_imgs, train_arrays[1]
        else:
            v_imgs, v_labels = resident_arrays(val_ds)
            v_imgs = {d: torch.from_numpy(v_imgs).to(d) for d in devices}
    rng = np.random.default_rng(cfg.seed)
    os.makedirs(os.path.dirname(best_path) or ".", exist_ok=True)
    for epoch in range(cfg.epochs):
        if resident:
            parts = []
            for grp in _resident_epoch_indices(len(train_ds), cfg, rng):
                for row in grp:  # each row split over the devices (≙ PartitionSpec(None, "dp"))
                    shares = [(t_imgs[i.device].index_select(0, i).float() / 255.0,
                               t_labels[i.device].index_select(0, i)) for (i,) in step.replicas.shard(row)]
                    parts.append(step.sharded(shares))
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

    Returns (the trained PVBNet on the mesh's first device, best val metrics).
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
