"""Scene preparation: PLY IO, mesh sampling, the ground-truth voxel scene,
the point-splat virtual camera and object setup."""

from .object_setup import MP_SCALE, ObjectScene, load_object, rotate_z_pose, toward_pose
from .ply import load_ply, save_ply_ascii, save_ply_binary
from .render import (
    colorfulness,
    object_pixel_rate,
    render_pointcloud,
    rgba_from_render,
)
from .voxel import GTSampleGrid, VoxelScene, make_gt_sample, voxel_downsample

__all__ = [
    "MP_SCALE",
    "ObjectScene",
    "load_object",
    "rotate_z_pose",
    "toward_pose",
    "load_ply",
    "save_ply_ascii",
    "save_ply_binary",
    "colorfulness",
    "object_pixel_rate",
    "render_pointcloud",
    "rgba_from_render",
    "GTSampleGrid",
    "VoxelScene",
    "make_gt_sample",
    "voxel_downsample",
]
