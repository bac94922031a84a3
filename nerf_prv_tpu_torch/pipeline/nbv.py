"""The NBV planning loop with all five view-selection methods.

≙ ``nbv_loop`` (``main.cpp:1718-2277``) and its method switch:

- 0 RandomIterative    — uniform random unchosen view (main.cpp:1974-1979)
- 1 RandomOneshot      — best-of-50 max-dispersion budget set, TSP-ordered,
                         replayed (main.cpp:1981-2037)
- 2 EnsembleRGB        — 2 NeRFs, per-candidate log RGB-variance uncertainty
                         (main.cpp:2039-2097)
- 3 EnsembleRGBDensity — 5 NeRFs, RGB variance + (1-density)^2
                         (main.cpp:2099-2161)
- 4 PVBCoverage (PRV)  — PRVNet view budget -> budget-sized view space ->
                         TSP path replayed (main.cpp:2163-2244)

Counterpart of ``nerf_prv_tpu/pipeline/nbv.py``.  NeRF training, PRVNet and
the ensemble scores run in-process on the runner's ``device``; the scores
are plain torch on the device (``score_candidates_rgb`` /
``score_candidates_rgb_density``, population variance as ``jnp.var``).
Methods 0 and 1 draw from ``np.random.default_rng(cfg.seed)``, as the JAX
package does, so both choose the same views.  Artifact layout (json/,
render_json/, metrics/, render/, train_time/, infer_time/, movement/,
run_time.txt, view_budget.txt) matches the reference's.
"""

from __future__ import annotations

import dataclasses
import os
import time
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.config import Config
from ..core.pose import camera_to_world
from ..core.transforms import add_frame, make_root, scaled_camera, write_transforms
from ..nerf.api import eval_nerf, save_metrics, screenshot_nerf, train_nerf
from ..nerf.model import NerfConfig
from ..planning.local_path import local_path
from ..planning.tsp import GlobalPathPlanner
from ..scene.object_setup import ObjectScene, _ensure_viewspace
from ..viewspace.hemisphere import ViewSpace

METHOD_NAMES = {
    0: "RandomIterative",
    1: "RandomOneshot",
    2: "EnsembleRGB",
    3: "EnsembleRGBDensity",
    4: "PVBCoverage",
}


def ensemble_uncertainty_rgb(images, device="cuda") -> float:
    """Sum over pixels of log channel variance (≙ main.cpp:2052-2085).

    ``images``: (E, H, W, 4) uint8 ensemble renders of one candidate view.
    """
    return float(score_candidates_rgb(_on(images, device)[None])[0])


def ensemble_uncertainty_rgb_density(images, device="cuda") -> float:
    """Mean RGB variance + (1 - mean density)^2 per pixel
    (≙ main.cpp:2112-2149)."""
    return float(score_candidates_rgb_density(_on(images, device)[None])[0])


def _on(images, device) -> torch.Tensor:
    """A tensor stays on its device; an array goes to ``device``."""
    if isinstance(images, torch.Tensor):
        return images
    return torch.as_tensor(np.asarray(images), device=device)


def score_candidates_rgb(images: torch.Tensor) -> torch.Tensor:
    """Batched EnsembleRGB uncertainty: (V, E, H, W, 4) uint8 -> (V,) on
    the images' device."""
    rgb = images[..., :3].to(torch.float32)
    var = torch.var(rgb, dim=1, correction=0)  # (V, H, W, 3), population variance
    return torch.sum(
        torch.where(var > 1e-10, torch.log(torch.clamp(var, min=1e-10)), 0.0),
        dim=(1, 2, 3),
    )


def score_candidates_rgb_density(images: torch.Tensor) -> torch.Tensor:
    """Batched EnsembleRGBDensity uncertainty: (V, E, H, W, 4) -> (V,)."""
    rgb = images[..., :3].to(torch.float32)
    var = torch.var(rgb, dim=1, correction=0).mean(dim=-1)  # (V, H, W)
    density = (images[..., 3].to(torch.float32) / 255.0).mean(dim=1)
    return torch.sum(var + (1.0 - density) ** 2, dim=(1, 2))


class NBVRunner:
    """One object x one method experiment (≙ NBV_Net_Labeler + nbv_loop);
    NeRFs train, and path lengths and scores are computed, on ``device``."""

    def __init__(
        self,
        cfg: Config,
        scene: ObjectScene,
        nerf_cfg: Optional[NerfConfig] = None,
        predictor=None,
        rng: Optional[np.random.Generator] = None,
        device="cuda",
    ):
        self.cfg = cfg
        self.device = torch.device(device)
        self.scene = scene
        self.nerf_cfg = nerf_cfg or NerfConfig(n_steps=cfg.n_steps)
        self.predictor = predictor
        self.rng = rng or np.random.default_rng(cfg.seed)
        self.view_space = scene.view_space
        self.init_views: Optional[np.ndarray] = None  # 5-view init positions

    # ------------------------------------------------------------ helpers
    def _json_root(self, low_res: bool = False) -> dict:
        cam = scaled_camera(self.cfg.camera, 16.0) if low_res else self.cfg.camera
        root = make_root(
            cam,
            self.cfg.ray_casting_aabb_scale,
            self.view_space.predicted_size,
            self.view_space.object_center,
        )
        return root

    def _coverage_rel(self, n_views: int, view_id: int) -> str:
        sub = "ShapeNet" if self.cfg.is_shape_net else "HB"
        return (
            f"../../../../Coverage_images/{sub}/{self.cfg.name_of_pcd}/"
            f"{n_views}/rgbaClip_{view_id}.png"
        )

    def _movement_cost(self, a: int, b: int) -> float:
        _, d = local_path(
            self.view_space.views[a],
            self.view_space.views[b],
            self.view_space.object_center + 1e-10,
            self.view_space.predicted_size,
        )
        return d

    def _train_eval(self, save_path: str, name: str, test_json: str) -> Dict[str, float]:
        t0 = time.time()
        params, _ = train_nerf(os.path.join(save_path, "json", f"{name}.json"), self.nerf_cfg, device=self.device)
        metrics = eval_nerf(params, test_json, self.nerf_cfg)
        save_metrics(os.path.join(save_path, "metrics", f"{name}.txt"), metrics)
        with open(os.path.join(save_path, "train_time", f"{name}.txt"), "w") as f:
            f.write(f"{time.time() - t0}\n")
        return metrics

    def _train_screenshot(self, save_path: str, name: str, ensemble_id: int, seed: int):
        params, _ = train_nerf(
            os.path.join(save_path, "json", f"{name}.json"), self.nerf_cfg, seed=seed, device=self.device
        )
        out_dir = os.path.join(save_path, "render", name, f"ensemble_{ensemble_id}")
        screenshot_nerf(
            params, os.path.join(save_path, "render_json", f"{name}.json"), out_dir, self.nerf_cfg
        )
        return out_dir

    # -------------------------------------------------------------- loop
    def nbv_loop(
        self,
        first_view_id: int,
        init_view_ids: Sequence[int],
        test_id: int = 0,
    ) -> Optional[str]:
        """≙ main.cpp:1718-2277.  Returns the experiment save_path."""
        cfg = self.cfg
        if self.init_views is None or len(self.init_views) == 0:
            raise ValueError("init_views is empty. read init (5) coverage view space first.")
        init_view_ids = list(init_view_ids)
        num_of_max_iteration = cfg.num_of_max_iteration

        # non-PRV methods replay the PRV method's budget (≙ main.cpp:1735-1749)
        if cfg.method_of_IG != 4:
            sub = "ShapeNet" if cfg.is_shape_net else "HB"
            budget_file = os.path.join(
                cfg.workspace,
                "Compare",
                sub,
                f"{cfg.name_of_pcd}_m4_v{len(init_view_ids)}_t{test_id}",
                "view_budget.txt",
            )
            if os.path.exists(budget_file):
                budget = int(float(open(budget_file).read().split()[0]))
                num_of_max_iteration = budget - 1

        # a budget can never exceed the candidate space (defensive: the
        # reference assumes 540 candidates >= any predicted budget)
        num_of_max_iteration = min(num_of_max_iteration, len(self.view_space) - 1)
        self._num_of_max_iteration = num_of_max_iteration
        save_path = f"{cfg.save_path}_v{len(init_view_ids)}_t{test_id}"
        for sub in ("json", "render_json", "metrics", "render", "train_time", "infer_time", "movement"):
            os.makedirs(os.path.join(save_path, sub), exist_ok=True)

        run_time_file = os.path.join(save_path, "run_time.txt")
        if os.path.exists(run_time_file):  # resume guard (≙ main.cpp:1761-1770)
            return save_path

        root_nbvs = self._json_root(low_res=False)
        root_render = self._json_root(low_res=True)

        # init views: all but the top view join the train json (≙ 1813-1848)
        first_init_view_id = -1
        top = self.view_space.object_center + [0, 0, cfg.view_space_radius]
        extra_frames = []
        for vid in init_view_ids:
            pos = self.init_views[vid]
            if np.linalg.norm(pos - top) < 1e-6:
                first_init_view_id = vid
                continue
            c2w = camera_to_world(pos[None], self.view_space.object_center)[0]
            extra_frames.append((self._coverage_rel(len(self.init_views), vid), c2w))

        # initial path over the init views (≙ 1849-1864)
        init_dis = 0.0
        ordered_init = init_view_ids
        if len(init_view_ids) > 1 and first_init_view_id >= 0:
            planner = GlobalPathPlanner(
                self.init_views,
                init_view_ids,
                self.view_space.object_center,
                self.view_space.predicted_size,
                first_init_view_id,
                device=self.device,
            )
            init_dis = planner.solve()
            ordered_init = planner.get_path_id_set()[::-1]
        with open(os.path.join(save_path, "movement", "init_path.txt"), "w") as f:
            for vid in ordered_init:
                f.write(f"{vid}\n")
        total_movement = 0.0
        with open(os.path.join(save_path, "movement", "-1.txt"), "w") as f:
            f.write(f"{first_view_id}\t{init_dis}\t{total_movement}\n")

        chosen: List[int] = [first_view_id]
        chosen_set = {first_view_id}
        oneshot: List[int] = []
        test_json = os.path.join(cfg.gt_path, "100.json")

        t_start = time.time()
        iteration = 0
        while True:
            # emit train + render jsons for this iteration (≙ 1884-1924)
            now_train = {**root_nbvs, "frames": list(root_nbvs["frames"])}
            now_render = {**root_render, "frames": list(root_render["frames"])}
            for rel, c2w in extra_frames:
                add_frame(now_train, rel, c2w)
            n_views = len(self.view_space)
            all_c2w = camera_to_world(
                self.view_space.views, self.view_space.object_center
            )
            for i in range(n_views):
                rel = self._coverage_rel(n_views, i)
                if i in chosen_set:
                    add_frame(now_train, rel, all_c2w[i])
                else:
                    add_frame(now_render, rel, all_c2w[i])
            write_transforms(os.path.join(save_path, "json", f"{iteration}.json"), now_train)
            write_transforms(
                os.path.join(save_path, "render_json", f"{iteration}.json"), now_render
            )

            if iteration == num_of_max_iteration:
                with open(run_time_file, "w") as f:
                    f.write(f"{time.time() - t_start}\n")
                if cfg.evaluate:  # final eval (≙ 1954-1964)
                    self._train_eval(save_path, str(iteration), test_json)
                if cfg.show:
                    # offline equivalent of the reference's `show` viewers
                    # (trajectory + view-space windows, main.cpp:3754-3823):
                    # export the chosen visit path and the view space
                    self._export_debug_viz(save_path, chosen)
                break

            t_infer = time.time()
            next_view_id = self._select_next(
                save_path, iteration, chosen, chosen_set, oneshot,
                first_view_id, init_view_ids, test_id,
            )
            if next_view_id is None:  # budget update shrank the space
                next_view_id = oneshot.pop(0)
                chosen = list(self._replay_chosen)
                chosen_set = set(chosen)
                num_of_max_iteration = self._replay_max_iteration
                self._num_of_max_iteration = num_of_max_iteration

            chosen.append(next_view_id)
            chosen_set.add(next_view_id)
            with open(os.path.join(save_path, "infer_time", f"{iteration}.txt"), "w") as f:
                f.write(f"{time.time() - t_infer}\n")

            d = self._movement_cost(chosen[iteration], chosen[iteration + 1])
            total_movement += d
            with open(os.path.join(save_path, "movement", f"{iteration}.txt"), "w") as f:
                f.write(f"{next_view_id}\t{d}\t{total_movement}\n")
            iteration += 1
        return save_path

    def _export_debug_viz(self, save_path: str, chosen: Sequence[int]) -> None:
        """Write debug_viz/: view-space + chosen-trajectory PLY and a 2-pane
        PNG (the headless stand-in for the reference's `show` flag)."""
        from ..utils.visualize import (
            export_trajectory_ply,
            export_view_space_ply,
            plot_view_space_png,
        )

        out = os.path.join(save_path, "debug_viz")
        os.makedirs(out, exist_ok=True)
        views = self.view_space.views
        center = self.view_space.object_center
        size = self.view_space.predicted_size
        export_view_space_ply(
            os.path.join(out, "view_space.ply"), views, start_id=chosen[0]
        )
        poly = export_trajectory_ply(
            os.path.join(out, "trajectory.ply"), views, list(chosen), center, size
        )
        plot_view_space_png(
            os.path.join(out, "view_space.png"), views,
            order=list(chosen), trajectory_points=poly,
        )

    # ----------------------------------------------------------- methods
    def _select_next(
        self, save_path, iteration, chosen, chosen_set, oneshot,
        first_view_id, init_view_ids, test_id,
    ) -> Optional[int]:
        cfg = self.cfg
        method = cfg.method_of_IG
        n_views = len(self.view_space)

        if method == 0:  # RandomIterative
            next_id = int(self.rng.integers(n_views))
            while next_id in chosen_set:
                next_id = int(self.rng.integers(n_views))
            return next_id

        if method == 1:  # RandomOneshot
            if not oneshot:
                best_set, best_dis = None, -np.inf
                for _ in range(50):  # ≙ check_num = 50
                    ids = {first_view_id}
                    while len(ids) < self._num_of_max_iteration + 1:
                        ids.add(int(self.rng.integers(n_views)))
                    pts = self.view_space.views[sorted(ids)]
                    diff = pts[:, None] - pts[None, :]
                    dis = np.triu(np.linalg.norm(diff, axis=-1), 1).sum()
                    if dis > best_dis:
                        best_dis, best_set = dis, sorted(ids)
                planner = GlobalPathPlanner(
                    self.view_space.views, best_set,
                    self.view_space.object_center, self.view_space.predicted_size,
                    first_view_id, device=self.device,
                )
                planner.solve()
                path = planner.get_path_id_set()
                oneshot.extend(path[1:])  # drop the start view
            return oneshot.pop(0)

        if method in (2, 3):  # Ensemble methods
            n_ensemble = cfg.ensemble_num_for_method
            dirs = []
            for e in range(n_ensemble):
                dirs.append(self._train_screenshot(save_path, str(iteration), e, seed=e))
            from PIL import Image

            candidates = [i for i in range(n_views) if i not in chosen_set]
            imgs = np.stack(
                [
                    np.stack(
                        [
                            np.asarray(
                                Image.open(
                                    os.path.join(d, f"rgbaClip_{i}.png")
                                ).convert("RGBA")
                            )
                            for d in dirs
                        ]
                    )
                    for i in candidates
                ]
            )  # (V, E, H, W, 4)
            score_fn = (
                score_candidates_rgb if method == 2 else score_candidates_rgb_density
            )
            scores = score_fn(torch.as_tensor(imgs, device=self.device)).cpu().numpy()
            return candidates[int(np.argmax(scores))]

        if method == 4:  # PVBCoverage — ours
            if oneshot:
                return oneshot.pop(0)
            if self.predictor is None:
                raise RuntimeError("PVBCoverage requires a BudgetPredictor")
            coverage_dir = os.path.join(cfg.gt_path, str(len(self.init_views)))
            budget = self.predictor.predict_from_coverage(coverage_dir, init_view_ids)
            # reload the budget-sized view space (≙ main.cpp:2194-2216)
            unit_views = _ensure_viewspace(cfg.viewspace_path, budget, self.device)
            self.view_space = ViewSpace(
                unit_views, self.scene.points, cfg.view_space_radius
            )
            now_first = self.view_space.top_view_id()
            planner = GlobalPathPlanner(
                self.view_space.views,
                list(range(len(self.view_space))),
                self.view_space.object_center,
                self.view_space.predicted_size,
                now_first,
                device=self.device,
            )
            planner.solve()
            path = planner.get_path_id_set()
            with open(os.path.join(save_path, "view_budget.txt"), "w") as f:
                f.write(f"{len(path)}\n")
            self._replay_chosen = [now_first]
            self._replay_max_iteration = len(path) - 1
            oneshot.extend(path[1:])
            return None  # signal: view space replaced, replay begins

        raise ValueError(f"unknown method {method}")
