"""The port's pipeline ``Config`` against the JAX package's: the same YAML
text read field by field, the same path properties and derived values."""

import dataclasses

import pytest
import torch

from nerf_prv_tpu.core.config import Config as JConfig
from nerf_prv_tpu_torch.core.config import CameraConfig, Config

torch.set_num_threads(1)

YAML = """%YAML:1.0
---
pre_path: "/data/prv"
model_path: "/data/models"
is_shape_net: 0
id_of_batch: 3
name_of_pcd: "Armadillo"
method_of_IG: 2
num_of_thread: 8
ground_truth_resolution: 0.0025
coverage_view_num_max: 40
points_size_cloud: 3
object_pixel_rate: 0.04
evaluate: 1
show: 0
num_of_views: 144
view_space_radius: 0.35
color_width: 640
color_height: 480
color_fx: 600.5
color_fy: 601.25
color_ppx: 320.75
color_ppy: 240.5
color_model: 0
color_k1: 0.01   # a comment
color_k2: -0.02
depth_scale: 0.001
unknown_key: 7
seed: 11
"""


def _both(tmp_path, **overrides):
    path = tmp_path / "cfg.yaml"
    path.write_text(YAML)
    return JConfig.from_yaml(str(path), **overrides), Config.from_yaml(str(path), **overrides)


def test_from_yaml_field_by_field(tmp_path):
    want, got = _both(tmp_path)
    assert [f.name for f in dataclasses.fields(Config)] == [f.name for f in dataclasses.fields(JConfig)]
    for f in dataclasses.fields(Config):
        a, b = getattr(got, f.name), getattr(want, f.name)
        if f.name == "camera":
            assert dataclasses.asdict(a) == dataclasses.asdict(b)
        else:
            assert a == b and type(a) is type(b), f.name
    assert got.workspace == "/data/prv" and got.is_shape_net is False and got.evaluate is True
    assert got.camera == CameraConfig(width=640, height=480, fx=600.5, fy=601.25, ppx=320.75, ppy=240.5,
                                      model=0, k1=0.01, k2=-0.02, depth_scale=0.001)


def test_from_yaml_overrides_and_replace(tmp_path):
    want, got = _both(tmp_path, name_of_pcd="LM5", seed=3)
    assert (got.name_of_pcd, got.seed) == (want.name_of_pcd, want.seed) == ("LM5", 3)
    r = got.replace(method_of_IG=3, id_of_batch=-1)
    assert (r.method_of_IG, r.id_of_batch) == (3, -1) and got.method_of_IG == 2


@pytest.mark.parametrize("shape_net", [True, False])
@pytest.mark.parametrize("batch", [-1, 0, 4])
@pytest.mark.parametrize("method", [0, 2, 3])
def test_paths_and_derived_values(shape_net, batch, method):
    kw = dict(workspace="ws", is_shape_net=shape_net, id_of_batch=batch, name_of_pcd="chair7",
              method_of_IG=method)
    got, want = Config(**kw), JConfig(**kw)
    for prop in ("gt_path", "save_path", "pvb_dataset_path", "effective_coverage_max",
                 "effective_coverage_add", "ensemble_num_for_method"):
        assert getattr(got, prop) == getattr(want, prop), prop
