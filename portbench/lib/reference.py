"""Plain float32 PyTorch reference of the NeRF protocol: the two fields, the
training march and step, the eval render and its scores.

Imports nothing of the program.  It follows the protocol's published
description (the voxel field: one corner-block row per sample, a trilinear
blend, a positional encoding and two small MLPs; the hash field: instant-ngp's
multiresolution hash encoding; both: spherical-harmonic view encoding,
stratified marching inside the object's bounding sphere tightened by
midpoint probes, alpha compositing with early termination, a Huber loss on a
random background, Adam with coupled weight decay on the MLPs only) in
float32 throughout, with TF32 off.  Where the configuration computes in
bfloat16 the reference computes in float32; ``lowp`` puts float8 (e4m3,
scaled per tensor) in those places instead: that is the control.

Parameters are K objects' stacked on a leading axis (``grid`` (K, g^3, 8F) or
``table`` (K, L*T, F); MLP weights (K, in, out)); points are (K, N, 3).

The training draws replay the protocol's stream from the seed: one
``torch.Generator`` on the device, the K fields' parameters in order (grid or
table, then sigma_w0, sigma_w1, color_w0, color_w1, color_w2), then per step
a (K, rays) float64 uniform that picks each object's hit pixel, the (K*rays,
3) background and the (K*rays, samples) jitter.
"""

from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional

import numpy as np
import torch
import torch.nn.functional as F

from .arith import hash_levels, train_phases

MIN_TRANSMITTANCE = 1e-4
SPHERE_CENTER, SPHERE_RADIUS = 0.5, 0.52
PRIMES = (1, 2654435761, 805459861)
CORNERS = tuple((i, j, k) for i in (0, 1) for j in (0, 1) for k in (0, 1))
PROBE_BLOCK = 2


@contextlib.contextmanager
def strict_f32():
    """float32 products without TF32, restored afterwards."""
    old = torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old


def fp8(x: torch.Tensor) -> torch.Tensor:
    """x rounded to float8 e4m3 with a per-tensor scale; gradients pass
    straight through."""
    s = x.detach().abs().amax().clamp_min(1e-30) / 448.0
    q = (x.detach() / s).to(torch.float8_e4m3fn).to(torch.float32) * s
    return x + (q - x).detach()


class Ref:
    """The reference at one configuration (the config file's ``nerf`` keys)
    and one precision for the configuration's bfloat16 parts:
    ``"float32"`` (the reference) or ``"float8"`` (the control)."""

    def __init__(self, cfg: dict, lowp: str = "float32"):
        self.cfg = cfg
        self.q = fp8 if lowp == "float8" else (lambda x: x)
        self.field = cfg["field_impl"]
        if self.field == "hash":
            g = cfg["grid"]
            self.levels, self.feat = g["levels"], g["features"]
            self.table_size = 1 << g["log2_table"]
            self.res, self.dense = hash_levels(g)

    # ------------------------------------------------------------ parameters
    def init_params(self, gen: torch.Generator, k: int) -> Dict[str, torch.Tensor]:
        cfg, dev = self.cfg, gen.device

        def uniform(shape, lim):
            u = torch.rand(shape, generator=gen, device=dev, dtype=torch.float32)
            return u * (2.0 * lim) - lim

        def dense(n_in, n_out):
            return uniform((n_in, n_out), (6.0 / (n_in + n_out)) ** 0.5)

        h, geo = cfg["hidden"], cfg["geo_features"] + 1
        sets = []
        for _ in range(k):
            if self.field == "voxel":
                g, f = cfg["voxel_grid_size"], cfg["voxel_features"]
                p = {"grid": uniform((g ** 3, 8 * f), 1e-4)}
                n_in = f + 6 * cfg["voxel_pe_freqs"]
            else:
                p = {"table": uniform((self.levels * self.table_size, self.feat), 1e-4)}
                n_in = self.levels * self.feat
            p["sigma_w0"] = dense(n_in, h)
            p["sigma_w1"] = dense(h, geo)
            p["color_w0"] = dense(16 + cfg["geo_features"], h)
            p["color_w1"] = dense(h, h)
            p["color_w2"] = dense(h, 3)
            sets.append(p)
        return {name: torch.stack([p[name] for p in sets]) for name in sets[0]}

    # ------------------------------------------------------------ encodings
    def _gather(self, table: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
        return _Rows.apply(table, idx)

    def voxel_features(self, grid, x):
        """(K, R, 8F) grid, (K, N, 3) points -> blended features (K, N, F)."""
        cfg = self.cfg
        g, f = cfg["voxel_grid_size"], cfg["voxel_features"]
        k, n = x.shape[:2]
        pos = torch.clamp(x, 0.0, 1.0 - 1e-6) * (g - 1)
        cell_f = torch.floor(pos)
        frac = pos - cell_f
        cell = cell_f.to(torch.int64)
        row = (cell[..., 0] * g + cell[..., 1]) * g + cell[..., 2]
        row = row + torch.arange(k, device=x.device)[:, None] * grid.shape[1]
        rows = self.q(self._gather(grid.reshape(-1, grid.shape[2]), row.reshape(-1)))
        w = corner_weights(frac.reshape(-1, 3))
        return (w[:, :, None] * rows.reshape(-1, 8, f)).sum(dim=1).reshape(k, n, f)

    def hash_features(self, table, x):
        """(K, L*T, F) tables, (K, N, 3) points -> features (K, N, L*F)."""
        k, n = x.shape[:2]
        dev = x.device
        res = torch.tensor(self.res, dtype=torch.float32, device=dev)[None, :, None, None]
        pos = x[:, None] * res  # (K, L, N, 3)
        cell_f = torch.minimum(torch.clamp_min(torch.floor(pos), 0.0), res - 1.0)
        frac = pos - cell_f
        cell = cell_f.to(torch.int64)
        r1 = (res.to(torch.int64) + 1)[..., 0]  # (1, L, 1)
        dense = torch.tensor(self.dense, device=dev)[None, :, None]
        base = (torch.arange(self.levels, device=dev)[None, :, None] * self.table_size
                + torch.arange(k, device=dev)[:, None, None] * table.shape[1])
        flat = table.reshape(-1, self.feat)
        acc = 0.0
        for di, dj, dk in CORNERS:
            cx, cy, cz = cell[..., 0] + di, cell[..., 1] + dj, cell[..., 2] + dk
            hashed = (cx * PRIMES[0] ^ cy * PRIMES[1] ^ cz * PRIMES[2]) & (self.table_size - 1)
            idx = torch.where(dense, cx + cy * r1 + cz * r1 * r1, hashed) + base
            vals = self._gather(flat, idx.reshape(-1)).reshape(k, self.levels, n, self.feat)
            wgt = ((frac[..., 0] if di else 1.0 - frac[..., 0]) * (frac[..., 1] if dj else 1.0 - frac[..., 1])
                   * (frac[..., 2] if dk else 1.0 - frac[..., 2]))
            acc = acc + vals * wgt[..., None]
        return acc.permute(0, 2, 1, 3).reshape(k, n, self.levels * self.feat)

    # ------------------------------------------------------------ the field
    def _mm(self, h, w):
        return torch.bmm(self.q(h), self.q(w))

    def density_raw(self, p, x):
        """(K, N, 3) -> raw log-density (K, N), geometry features (K, N, G)."""
        if self.field == "voxel":
            h = torch.cat([self.voxel_features(p["grid"], x), pe_encode(x, self.cfg["voxel_pe_freqs"])], dim=-1)
        else:
            h = self.hash_features(p["table"], x)
        out = self._mm(torch.relu(self._mm(h, p["sigma_w0"])), p["sigma_w1"])
        return out[..., 0], out[..., 1:]

    def radiance(self, p, geo, dirs):
        h = torch.cat([sh_deg4(dirs), geo], dim=-1)
        h = torch.relu(self._mm(h, p["color_w0"]))
        h = torch.relu(self._mm(h, p["color_w1"]))
        return torch.sigmoid(self._mm(h, p["color_w2"]))

    def field_at(self, p, x, dirs):
        raw, geo = self.density_raw(p, x)
        return torch.exp(raw), self.radiance(p, geo, dirs)

    # ------------------------------------------------------------ marching
    def probe(self, p, o, d, tmin, tmax, valid, nc):
        """Midpoint probes of the field's density: the tightened
        (t_lo, t_hi, any occupied) of each ray (K, N)."""
        k, n = o.shape[:2]
        base = (torch.arange(nc, dtype=torch.float32, device=o.device) + 0.5) / nc
        span = tmax - tmin
        ts = tmin[..., None] + base * span[..., None]
        pos = torch.clamp(o[..., None, :] + d[..., None, :] * ts[..., None], 0.0, 1.0 - 1e-6)
        raw, _ = self.density_raw(p, pos.reshape(k, n * nc, 3))
        sigma = torch.exp(raw).reshape(k, n, nc) * valid[..., None]
        return clamp_occupied(sigma, tmin, span, nc)

    def march(self, p, o, d, tlo, thi, occ, ns, jitter):
        """``ns`` samples inside [tlo, thi] -> rgb (K, N, 3), alpha (K, N)."""
        k, n = o.shape[:2]
        span = (thi - tlo) / ns
        base = torch.arange(ns, dtype=torch.float32, device=o.device)
        ts = tlo[..., None] + (base + jitter) * span[..., None]
        pos = torch.clamp(o[..., None, :] + d[..., None, :] * ts[..., None], 0.0, 1.0 - 1e-6)
        dirs = d[..., None, :].expand(k, n, ns, 3)
        sigma, rgb = self.field_at(p, pos.reshape(k, n * ns, 3), dirs.reshape(k, n * ns, 3))
        sigma = sigma.reshape(k, n, ns) * occ[..., None]
        return composite(sigma, rgb.reshape(k, n, ns, 3), span[..., None])

    def train_rays(self, p, o, d, jitter, coarse):
        tmin, tmax, valid = ray_sphere(o, d)
        if coarse > 0:
            with torch.no_grad():
                lo, hi, any_occ = self.probe(p, o, d, tmin, tmax, valid, coarse)
            tmin = torch.where(any_occ, lo, tmin)
            tmax = torch.where(any_occ, hi, tmax)
        return self.march(p, o, d, tmin, tmax, valid, jitter.shape[-1], jitter)

    # ------------------------------------------------------------ training
    def optimizer(self, p):
        c = self.cfg
        sparse = [v for name, v in p.items() if name in ("grid", "table")]
        dense = [v for name, v in p.items() if name not in ("grid", "table")]
        return torch.optim.Adam(
            [{"params": dense, "weight_decay": c["weight_decay"]}, {"params": sparse, "weight_decay": 0.0}],
            lr=c["lr"], betas=(0.9, 0.99), eps=1e-15)

    def huber(self, err):
        delta = self.cfg["huber_delta"]
        a = torch.abs(err)
        return torch.where(a <= delta, 0.5 * err * err, delta * (a - 0.5 * delta))

    def train(self, data: "TrainData", seed: int, steps: Optional[int] = None, fault: str = "",
              keep_init: bool = False) -> "TrainResult":
        """Train K fields on ``data`` from ``seed``: every step's (K,) losses,
        the first step's gradient norm per leaf and object, the final
        parameters (and, with ``keep_init``, the initial ones).

        ``fault`` plants one of the faults a check must catch: ``"half"``
        takes each object's mean loss over the first half of its rays."""
        c = self.cfg
        k = data.k
        with strict_f32():
            gen = torch.Generator(device=data.device).manual_seed(seed)
            p = self.init_params(gen, k)
            init = {name: v.clone() for name, v in p.items()} if keep_init else None
            for v in p.values():
                v.requires_grad_(True)
            opt = self.optimizer(p)
            losses, grad0 = [], None
            n_rays = c["train_rays"]
            done = 0
            for coarse, ns, n_steps in train_phases(c):
                for _ in range(n_steps):
                    if steps is not None and done >= steps:
                        break
                    o, d, target, bg = data.sample(gen, n_rays)
                    jitter = torch.rand((k * n_rays, ns), generator=gen, device=data.device)
                    rgb, acc = self.train_rays(p, o.reshape(k, n_rays, 3), d.reshape(k, n_rays, 3),
                                               jitter.reshape(k, n_rays, ns), coarse)
                    err = rgb.reshape(-1, 3) + bg * (1.0 - acc.reshape(-1, 1)) - target
                    per = self.huber(err).reshape(k, n_rays, 3)
                    if fault == "half":
                        per = per[:, : n_rays // 2]
                    loss = per.mean(dim=(1, 2))
                    opt.zero_grad(set_to_none=True)
                    loss.sum().backward()
                    if grad0 is None:
                        grad0 = {name: v.grad.detach().reshape(k, -1).norm(dim=1) for name, v in p.items()}
                    opt.step()
                    losses.append(loss.detach())
                    done += 1
        params = {name: v.detach() for name, v in p.items()}
        return TrainResult(torch.stack(losses).cpu().numpy(), grad0, params, init)

    # ------------------------------------------------------------ eval render
    @torch.no_grad()
    def voxel_aux(self, p):
        """Per-cell corner raw densities (g^3, 8) and the dilated block-max
        sigma volume of one voxel field (parameters without the K axis)."""
        c = self.cfg
        g, f = c["voxel_grid_size"], c["voxel_features"]
        rows = p["grid"]
        ar = torch.arange(g, dtype=torch.float32, device=rows.device)
        cell = torch.stack(torch.meshgrid(ar, ar, ar, indexing="ij"), dim=-1).reshape(-1, 3)
        one = {name: v[None] for name, v in p.items()}
        cs = []
        for ci, corner in enumerate(CORNERS):
            pos = torch.clamp((cell + torch.tensor(corner, dtype=torch.float32, device=rows.device)) / (g - 1),
                              0.0, 1.0)
            h = torch.cat([self.q(rows[:, ci * f:(ci + 1) * f]), pe_encode(pos, c["voxel_pe_freqs"])], dim=-1)
            out = self._mm(torch.relu(self._mm(h[None], one["sigma_w0"])), one["sigma_w1"])[0]
            cs.append(out[:, 0])
        cs = torch.stack(cs, dim=-1)
        cell_max = torch.exp(cs.amax(dim=-1)).reshape(g, g, g)
        cell_max[g - 1], cell_max[:, g - 1], cell_max[:, :, g - 1] = 0.0, 0.0, 0.0
        nb = -(-g // PROBE_BLOCK)
        pad = nb * PROBE_BLOCK - g
        cm = F.pad(cell_max, (0, pad) * 3)
        pooled = cm.reshape(nb, PROBE_BLOCK, nb, PROBE_BLOCK, nb, PROBE_BLOCK).amax(dim=(1, 3, 5))
        dil = F.max_pool3d(F.pad(pooled[None, None], (1,) * 6, mode="replicate"), 3, 1)[0, 0]
        return cs, dil

    @torch.no_grad()
    def render_rays(self, p, o, d, aux=None):
        """Deterministic eval march of rays (N, 3) of one field (parameters
        without the K axis) -> rgb (N, 3), alpha (N,), sphere hits, rays
        marched."""
        c = self.cfg
        one = {name: v[None] for name, v in p.items()}
        tmin, tmax, valid = ray_sphere(o, d)
        hit = torch.nonzero(valid)[:, 0]  # a ray that misses the sphere composites to zero
        n_rays = o.shape[0]
        o, d, tmin, tmax, valid = o[hit], d[hit], tmin[hit], tmax[hit], valid[hit]
        if self.field == "voxel":
            cs, pooled = aux
            g = c["voxel_grid_size"]
            n1 = max(c["render_probe_coarse"], -(-int(1.04 * (g - 1)) // (3 * PROBE_BLOCK)))
            span = tmax - tmin
            ts1 = tmin[:, None] + (torch.arange(n1, dtype=torch.float32, device=o.device) + 0.5) / n1 * span[:, None]
            pos1 = torch.clamp(o[:, None] + d[:, None] * ts1[..., None], 0.0, 1.0 - 1e-6)
            nb = pooled.shape[0]
            b = torch.clamp((pos1 * (g - 1) / PROBE_BLOCK).to(torch.int64), 0, nb - 1)
            sig1 = pooled[b[..., 0], b[..., 1], b[..., 2]]
            occ1 = (1.0 - torch.exp(-sig1 * (span[:, None] / n1)) > 1e-3) & valid[:, None]
            any1 = occ1.any(dim=-1)
            first1 = first_true(occ1).to(torch.float32)
            last1 = (n1 - 1 - first_true(torch.flip(occ1, dims=[-1]))).to(torch.float32)
            t1min = tmin + torch.clamp_min(first1 - 0.5, 0.0) / n1 * span
            t1max = tmin + torch.clamp_max(last1 + 1.5, float(n1)) / n1 * span
            n2 = c["render_probe_fine"]
            span2 = t1max - t1min
            ts2 = t1min[:, None] + (torch.arange(n2, dtype=torch.float32, device=o.device) + 0.5) / n2 * span2[:, None]
            pos2 = torch.clamp(o[:, None] + d[:, None] * ts2[..., None], 0.0, 1.0 - 1e-6).reshape(-1, 3)
            pos = pos2 * (g - 1)
            cell_f = torch.floor(pos)
            cell = cell_f.to(torch.int64)
            row = (cell[:, 0] * g + cell[:, 1]) * g + cell[:, 2]
            sig2 = torch.exp((cs[row] * corner_weights(pos - cell_f)).sum(dim=-1)).reshape(-1, n2)
            tlo, thi, any2 = clamp_occupied(sig2, t1min, span2, n2)
            occ = valid & any1 & any2
            ns = c["render_n_samples"]
        else:
            tlo, thi, any_occ = self.probe(one, o[None], d[None], tmin[None], tmax[None], valid[None],
                                           c["render_coarse"])
            tlo, thi, occ = tlo[0], thi[0], valid & any_occ[0]
            # the protocol's MLP-probed eval marches at least 32 samples
            ns = max(c["render_n_samples"], 32)
        keep = torch.nonzero(occ)[:, 0]
        rgb = torch.zeros((n_rays, 3), device=o.device)
        alpha = torch.zeros((n_rays,), device=o.device)
        if keep.numel():
            r, a = self.march(one, o[keep][None], d[keep][None], tlo[keep][None], thi[keep][None],
                              torch.ones_like(keep, dtype=torch.bool)[None], ns, 0.5)
            rgb[hit[keep]], alpha[hit[keep]] = r[0], a[0]
        return rgb, alpha, int(hit.numel()), int(keep.numel()), ns

    @torch.no_grad()
    def evaluate(self, p, views: "EvalViews", fault: str = "") -> "EvalResult":
        """Render every test frame of one field and score it against the
        frames: the protocol's eval.  ``fault``: ``"frame"`` zeroes the
        first frame's render, ``"half"`` scores the first half of the
        frames only."""
        with strict_f32():
            aux = self.voxel_aux(p) if self.field == "voxel" else None
            psnr, ssim_v, mse = [], [], []
            hits = marched = 0
            dirs_cam = views.dirs_cam
            n_frames = views.origins.shape[0] // (2 if fault == "half" else 1)
            for f in range(n_frames):
                d = torch.einsum("ij,nj->ni", views.rotations[f], dirs_cam)
                d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
                o = views.origins[f].expand_as(d)
                rgb, _, h, m, ns = self.render_rays(p, o, d, aux)
                hits, marched = hits + h, marched + m
                img = rgb.reshape(views.height, views.width, 3)
                if fault == "frame" and f == 0:
                    img = torch.zeros_like(img)
                gt = views.pixels[f].to(torch.float32) / 255.0
                a = torch.clamp(img, 0.0, 1.0)
                r = torch.clamp(gt[..., :3] * gt[..., 3:4], 0.0, 1.0)
                e = torch.mean((a - r) ** 2)
                mse.append(float(e))
                psnr.append(float(-10.0 * torch.log10(torch.clamp_min(e, 1e-12))))
                ssim_v.append(float(ssim(a, r)))
        psnr, mse = np.array(psnr), np.array(mse)
        scores = dict(PSNR=float(psnr.mean()), SSIM=float(np.mean(ssim_v)),
                      PSNR_avgmse=float(-10.0 * np.log10(max(mse.mean(), 1e-12))),
                      min_PSNR=float(psnr.min()), max_PSNR=float(psnr.max()))
        return EvalResult(scores, hits, marched, ns)


class TrainResult(NamedTuple):
    losses: np.ndarray                  # (steps, K)
    grad0: Dict[str, torch.Tensor]      # leaf -> (K,) first-step gradient norms
    params: Dict[str, torch.Tensor]
    init: Optional[Dict[str, torch.Tensor]]


class EvalResult(NamedTuple):
    scores: Dict[str, float]
    sphere_hits: int   # rays that hit the bounding sphere, all frames
    marched: int       # rays marched after the probes, all frames
    samples: int       # samples a marched ray takes


class _Rows(torch.autograd.Function):
    """``table[idx]`` whose backward adds the rows' gradients back with
    ``index_add_`` (plain float32 atomics)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table[idx]

    @staticmethod
    def backward(ctx, g):
        (idx,) = ctx.saved_tensors
        out = torch.zeros((ctx.rows, g.shape[1]), dtype=g.dtype, device=g.device)
        return out.index_add_(0, idx, g), None


def corner_weights(frac):
    fx, fy, fz = frac[:, 0], frac[:, 1], frac[:, 2]
    return torch.stack([(fx if i else 1.0 - fx) * (fy if j else 1.0 - fy) * (fz if k else 1.0 - fz)
                        for i, j, k in CORNERS], dim=-1)


def pe_encode(x, n_freqs):
    """(..., 3) -> (..., 6 n_freqs): per frequency 2^i pi, sin of x, y, z then cos."""
    freqs = 2.0 ** torch.arange(n_freqs, dtype=torch.float32, device=x.device) * math.pi
    ang = x[..., None, :] * freqs[:, None]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1).reshape(x.shape[:-1] + (6 * n_freqs,))


def sh_deg4(d):
    """Real spherical harmonics of degrees 0-3 (16 coefficients) of unit d."""
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    xx, yy, zz = x * x, y * y, z * z
    return torch.stack([
        torch.full_like(x, 0.28209479177387814), -0.48860251190291987 * y, 0.48860251190291987 * z,
        -0.48860251190291987 * x, 1.0925484305920792 * x * y, -1.0925484305920792 * y * z,
        0.31539156525252005 * (3.0 * zz - 1.0), -1.0925484305920792 * x * z, 0.5462742152960396 * (xx - yy),
        -0.5900435899266435 * y * (3.0 * xx - yy), 2.890611442640554 * x * y * z,
        -0.4570457994644658 * y * (5.0 * zz - 1.0), 0.3731763325901154 * z * (5.0 * zz - 3.0),
        -0.4570457994644658 * x * (5.0 * zz - 1.0), 1.445305721320277 * (xx - yy) * z,
        -0.5900435899266435 * x * (xx - 3.0 * yy)], dim=-1)


def ray_sphere(o, d, center=SPHERE_CENTER, radius=SPHERE_RADIUS):
    oc = o - center
    b = torch.sum(oc * d, dim=-1)
    c = torch.sum(oc * oc, dim=-1) - radius * radius
    disc = b * b - c
    sq = torch.sqrt(torch.clamp_min(disc, 0.0))
    tmin = torch.clamp_min(-b - sq, 0.0)
    tmax = torch.clamp_min(-b + sq, 0.0)
    return tmin, torch.maximum(tmax, tmin), (disc > 0.0) & (tmax > tmin)


def first_true(mask):
    return torch.argmax(mask.to(torch.int32), dim=-1)


def clamp_occupied(sigma, tmin, span, nc):
    """The occupied, not yet saturated stretch of the probes (..., nc), with
    one probe segment of margin each side."""
    alpha = 1.0 - torch.exp(-sigma * (span[..., None] / nc))
    occ = alpha > 1e-3
    any_occ = occ.any(dim=-1)
    first = first_true(occ)
    last = nc - 1 - first_true(torch.flip(occ, dims=[-1]))
    trans = torch.cumprod(1.0 - alpha + 1e-10, dim=-1)
    sat = trans < MIN_TRANSMITTANCE
    first_sat = torch.where(sat.any(dim=-1), first_true(sat), nc - 1)
    last = torch.minimum(last, first_sat)
    lo = torch.clamp_min(first - 1, 0).to(torch.float32) / nc
    hi = torch.clamp_max(last + 2, nc).to(torch.float32) / nc
    return tmin + lo * span, tmin + hi * span, any_occ


def composite(sigma, rgb, delta):
    """sigma (..., S), rgb (..., S, 3), delta (..., 1) -> rgb (..., 3), alpha (...)."""
    alpha = 1.0 - torch.exp(-sigma * delta)
    a = 1.0 - alpha + 1e-10
    trans = torch.cat([torch.ones_like(a[..., :1]), torch.cumprod(a, dim=-1)[..., :-1]], dim=-1)
    w = torch.where(trans > MIN_TRANSMITTANCE, trans * alpha, torch.zeros_like(alpha))
    return (w[..., None] * rgb).sum(dim=-2), w.sum(dim=-1)


def ssim(img, ref, size=11, sigma=1.5, c1=0.01 ** 2, c2=0.03 ** 2):
    """Mean SSIM of two (H, W, 3) images: Gaussian window, valid borders,
    per channel."""
    x = torch.arange(size, dtype=torch.float32, device=img.device) - (size - 1) / 2.0
    g = torch.exp(-0.5 * (x / sigma) ** 2)
    g = g / g.sum()

    def blur(t):
        t = t.permute(2, 0, 1)[:, None]  # (3, 1, H, W)
        t = F.conv2d(t, g.reshape(1, 1, size, 1))
        return F.conv2d(t, g.reshape(1, 1, 1, size))

    mx, my = blur(img), blur(ref)
    sxx = blur(img * img) - mx * mx
    syy = blur(ref * ref) - my * my
    sxy = blur(img * ref) - mx * my
    num = (2.0 * mx * my + c1) * (2.0 * sxy + c2)
    den = (mx * mx + my * my + c1) * (sxx + syy + c2)
    return torch.mean(num / den)


# ---------------------------------------------------------------- data
def pixel_dirs(cam, u, v):
    """Camera-frame unit directions through pixel centres (pinhole)."""
    x = (u + 0.5 - cam.ppx) / cam.fx
    y = (v + 0.5 - cam.ppy) / cam.fy
    d = torch.stack([x, y, torch.ones_like(x)], dim=-1)
    return d / torch.linalg.norm(d, dim=-1, keepdim=True)


def frame_dirs(cam, device):
    u, v = torch.meshgrid(torch.arange(cam.width, dtype=torch.float32, device=device),
                          torch.arange(cam.height, dtype=torch.float32, device=device), indexing="xy")
    return pixel_dirs(cam, u.reshape(-1), v.reshape(-1))


class TrainData:
    """K objects' training frames on the device, and the protocol's ray
    sampler over each object's sphere-hitting pixels."""

    def __init__(self, views, cam, device):
        self.device = torch.device(device)
        self.cam = cam
        self.k = len(views)
        nf = max(v.origins.shape[0] for v in views)
        self.nf, hw = nf, cam.height * cam.width
        px = np.zeros((self.k, nf, cam.height, cam.width, 4), np.uint8)
        rot = np.tile(np.eye(3, dtype=np.float32), (self.k, nf, 1, 1))
        org = np.zeros((self.k, nf, 3), np.float32)
        for i, v in enumerate(views):
            f = v.origins.shape[0]
            px[i, :f], rot[i, :f], org[i, :f] = v.pixels, v.rotations, v.origins
        self.pixels = torch.from_numpy(px).to(self.device).reshape(-1, 4)
        self.rot = torch.from_numpy(rot).to(self.device).reshape(-1, 3, 3)
        self.org = torch.from_numpy(org).to(self.device).reshape(-1, 3)
        d_cam = frame_dirs(cam, self.device)
        pools, n_hit = [], []
        for i, v in enumerate(views):
            lo, f = i * nf, v.origins.shape[0]
            d = torch.einsum("fij,nj->fni", self.rot[lo:lo + f], d_cam)
            _, _, valid = ray_sphere(self.org[lo:lo + f][:, None, :], d)
            hits = torch.nonzero(valid.reshape(-1))[:, 0] + lo * hw
            pools.append(hits)
            n_hit.append(max(hits.numel(), 1))
        width = max(p.numel() for p in pools)
        self.pools = torch.stack([F.pad(p, (0, width - p.numel())) for p in pools])
        self.n_hit = torch.tensor(n_hit, dtype=torch.float64, device=self.device)

    def sample(self, gen, n_rays):
        """(origins, dirs, target, bg), each (K*n_rays, 3), object-major."""
        u = torch.rand((self.k, n_rays), generator=gen, device=self.device, dtype=torch.float64)
        flat = torch.gather(self.pools, 1, (u * self.n_hit[:, None]).to(torch.int64)).reshape(-1)
        hw, w = self.cam.height * self.cam.width, self.cam.width
        f, pix = flat // hw, flat % hw
        d_cam = pixel_dirs(self.cam, (pix % w).to(torch.float32), (pix // w).to(torch.float32))
        d = torch.einsum("nij,nj->ni", self.rot[f], d_cam)
        d = d / torch.linalg.norm(d, dim=-1, keepdim=True)
        rgba = self.pixels[flat].to(torch.float32) / 255.0
        bg = torch.rand((flat.shape[0], 3), generator=gen, device=self.device)
        target = rgba[:, :3] * rgba[:, 3:4] + bg * (1.0 - rgba[:, 3:4])
        return self.org[f], d, target, bg


class EvalViews(NamedTuple):
    origins: torch.Tensor    # (F, 3)
    rotations: torch.Tensor  # (F, 3, 3)
    pixels: torch.Tensor     # (F, H, W, 4) uint8
    dirs_cam: torch.Tensor   # (H*W, 3)
    width: int
    height: int


def eval_views(v, cam, device) -> EvalViews:
    device = torch.device(device)
    return EvalViews(torch.from_numpy(v.origins).to(device), torch.from_numpy(v.rotations).to(device),
                     torch.from_numpy(v.pixels).to(device), frame_dirs(cam, device), cam.width, cam.height)
