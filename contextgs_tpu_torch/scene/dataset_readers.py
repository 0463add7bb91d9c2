"""Scene loaders: COLMAP and Blender (NeRF-synthetic) datasets (port of
`contextgs_tpu/scene/dataset_readers.py`).

The same split rules (every-8th eval split or lod-based), the same nerf++
normalization (radius = 1.1 · max camera distance from the mean centre), the
same resolution policy (auto-downscale of images wider than 1600 px) and the
same Blender OpenGL→COLMAP axis flip and background compositing.

PNG images are read by `utils/png.py`, with no Pillow. A JPEG (or any other
format) and a resize go through Pillow as the JAX package does, imported
only then: where Pillow does not import, those two cases raise and say so.
A PNG scene at its own size never touches Pillow.
"""

from __future__ import annotations

import json
import os
from dataclasses import dataclass, field
from typing import List, Optional

import numpy as np

from contextgs_tpu_torch.scene import colmap
from contextgs_tpu_torch.scene.cameras import Camera
from contextgs_tpu_torch.scene.ply_io import (read_point_cloud,
                                              write_point_cloud)
from contextgs_tpu_torch.utils import png
from contextgs_tpu_torch.utils.graphics import (focal_to_fov, fov_to_focal,
                                                qvec_to_rotmat, world_to_view)


@dataclass
class SceneInfo:
    points: np.ndarray            # [N,3]
    colors: np.ndarray            # [N,3] in [0,1]
    normals: np.ndarray           # [N,3]
    train_cameras: List[Camera]
    test_cameras: List[Camera]
    translate: np.ndarray = field(default_factory=lambda: np.zeros(3))
    radius: float = 1.0
    ply_path: str = ""


def _pillow(why: str):
    try:
        from PIL import Image
    except ImportError as exc:
        raise ImportError(
            f"{why} needs Pillow, which does not import here; PNG images at "
            "their own size are read without it") from exc
    return Image


def _load_image(path: str) -> np.ndarray:
    """Load an image file as float32 in [0,1], [H,W,C] ([H,W] for grey)."""
    if png.is_png(path):
        return png.read_png(path).astype(np.float32) / 255.0
    Image = _pillow(f"reading {path} (not a PNG)")
    with Image.open(path) as im:
        return np.asarray(im, dtype=np.float32) / 255.0


def _resize_image(img: np.ndarray, size: tuple[int, int]) -> np.ndarray:
    """Resize to (width, height) with `Image.resize`'s default filter
    (bicubic), as the JAX package does."""
    w, h = size
    if img.shape[1] == w and img.shape[0] == h:
        return img
    Image = _pillow(f"resizing an image to {w}x{h}")
    pil = Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8))
    return np.asarray(pil.resize((w, h)), dtype=np.float32) / 255.0


def _target_resolution(orig_w: int, orig_h: int, resolution: int,
                       resolution_scale: float = 1.0) -> tuple[int, int]:
    """Resolution policy (ref utils/camera_utils.py:19-40)."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        global_down = orig_w / 1600 if orig_w > 1600 else 1.0
    else:
        global_down = orig_w / resolution
    scale = global_down * resolution_scale
    return int(orig_w / scale), int(orig_h / scale)


def _nerfpp_norm(cameras: List[Camera]) -> tuple[np.ndarray, float]:
    """Camera-extent normalization (ref dataset_readers.py:47-68)."""
    centers = []
    for cam in cameras:
        w2c = world_to_view(cam.R, cam.T)
        centers.append(np.linalg.inv(w2c)[:3, 3])
    centers = np.stack(centers)
    center = centers.mean(axis=0)
    diagonal = np.linalg.norm(centers - center, axis=1).max()
    return -center, float(diagonal * 1.1)


def load_colmap_scene(path: str, images: str = "images",
                      eval_split: bool = True, lod: int = 0,
                      llffhold: int = 8, resolution: int = -1,
                      load_images: bool = True) -> SceneInfo:
    """Read a COLMAP scene (ref readColmapSceneInfo, dataset_readers.py:142-200)."""
    sparse = os.path.join(path, "sparse/0")
    if os.path.exists(os.path.join(sparse, "images.bin")):
        extr = colmap.read_images_binary(os.path.join(sparse, "images.bin"))
        intr = colmap.read_cameras_binary(os.path.join(sparse, "cameras.bin"))
    else:
        extr = colmap.read_images_text(os.path.join(sparse, "images.txt"))
        intr = colmap.read_cameras_text(os.path.join(sparse, "cameras.txt"))

    infos = []
    for key in extr:
        im = extr[key]
        cam = intr[im.camera_id]
        R = qvec_to_rotmat(im.qvec).T
        T = np.array(im.tvec)
        if cam.model in ("SIMPLE_PINHOLE", "SIMPLE_RADIAL"):
            fov_y = focal_to_fov(cam.params[0], cam.height)
            fov_x = focal_to_fov(cam.params[0], cam.width)
        elif cam.model == "PINHOLE":
            fov_y = focal_to_fov(cam.params[1], cam.height)
            fov_x = focal_to_fov(cam.params[0], cam.width)
        else:
            raise ValueError(
                f"unsupported COLMAP camera model {cam.model}: only undistorted "
                "(PINHOLE / SIMPLE_PINHOLE) datasets are supported")
        image_path = os.path.join(path, images, os.path.basename(im.name))
        name = os.path.basename(image_path).split(".")[0]
        infos.append((name, R, T, fov_x, fov_y, image_path, cam.width,
                      cam.height))

    infos.sort(key=lambda x: x[0])

    cameras = []
    for uid, (name, R, T, fov_x, fov_y, image_path, w, h) in enumerate(infos):
        img = None
        if load_images:
            img = _load_image(image_path)[..., :3]
            tw, th = _target_resolution(img.shape[1], img.shape[0], resolution)
            img = _resize_image(img, (tw, th))
            w, h = tw, th
        cameras.append(Camera(uid=uid, colmap_id=uid, R=R, T=T, fov_x=fov_x,
                              fov_y=fov_y, image=img, image_name=name,
                              width=w, height=h))

    if eval_split:
        if lod > 0:
            # BungeeNeRF-style LOD split (ref dataset_readers.py:158-167)
            if lod < 50:
                train = [c for i, c in enumerate(cameras) if i > lod]
                test = [c for i, c in enumerate(cameras) if i <= lod]
            else:
                train = [c for i, c in enumerate(cameras) if i <= lod]
                test = [c for i, c in enumerate(cameras) if i > lod]
        else:
            train = [c for i, c in enumerate(cameras) if i % llffhold != 0]
            test = [c for i, c in enumerate(cameras) if i % llffhold == 0]
    else:
        train, test = cameras, []

    translate, radius = _nerfpp_norm(train)

    ply_path = os.path.join(sparse, "points3D.ply")
    if not os.path.exists(ply_path):
        if os.path.exists(os.path.join(sparse, "points3D.bin")):
            xyz, rgb, _ = colmap.read_points3d_binary(
                os.path.join(sparse, "points3D.bin"))
        else:
            xyz, rgb, _ = colmap.read_points3d_text(
                os.path.join(sparse, "points3D.txt"))
        write_point_cloud(ply_path, xyz, rgb)
    xyz, rgb, normals = read_point_cloud(ply_path)

    return SceneInfo(points=xyz, colors=rgb, normals=normals,
                     train_cameras=train, test_cameras=test,
                     translate=translate, radius=radius, ply_path=ply_path)


def _read_transforms(path: str, file: str, white_background: bool,
                     extension: str = ".png") -> List[Camera]:
    """Blender transforms reader (ref readCamerasFromTransforms,
    dataset_readers.py:254-318): OpenGL→COLMAP flip, alpha compositing."""
    with open(os.path.join(path, file)) as f:
        meta = json.load(f)
    fov_x = meta.get("camera_angle_x")
    cameras = []
    for idx, frame in enumerate(meta["frames"]):
        fp = frame["file_path"]
        cam_name = fp if fp.endswith(extension) else fp + extension
        c2w = np.array(frame["transform_matrix"], dtype=np.float64)
        c2w[:3, 1:3] *= -1
        w2c = np.linalg.inv(c2w)
        R = w2c[:3, :3].T
        T = w2c[:3, 3]

        img = _load_image(os.path.join(path, cam_name))
        bg = np.ones(3) if white_background else np.zeros(3)
        if img.shape[-1] == 4:
            img = img[..., :3] * img[..., 3:4] + bg * (1 - img[..., 3:4])
        h, w = img.shape[:2]
        if fov_x is not None:
            fy = focal_to_fov(fov_to_focal(fov_x, w), h)
            fx = fov_x
        else:
            fy = focal_to_fov(frame["fl_y"], h)
            fx = focal_to_fov(frame["fl_x"], w)
        cameras.append(Camera(uid=idx, colmap_id=idx, R=R, T=T, fov_x=fx,
                              fov_y=fy, image=img.astype(np.float32),
                              image_name=os.path.basename(fp), width=w,
                              height=h))
    return cameras


def load_blender_scene(path: str, white_background: bool = False,
                       eval_split: bool = True, extension: str = ".png",
                       ply_path: Optional[str] = None,
                       rng: Optional[np.random.Generator] = None) -> SceneInfo:
    """NeRF-synthetic loader (ref readNerfSyntheticInfo, dataset_readers.py:319-353)."""
    train = _read_transforms(path, "transforms_train.json", white_background,
                             extension)
    test = _read_transforms(path, "transforms_test.json", white_background,
                            extension)
    if not eval_split:
        train, test = train + test, []
    translate, radius = _nerfpp_norm(train)

    if ply_path is None:
        ply_path = os.path.join(path, "points3d.ply")
    if not os.path.exists(ply_path):
        rng = rng or np.random.default_rng(0)
        num_pts = 10_000
        xyz = rng.random((num_pts, 3)) * 2.6 - 1.3
        rgb = rng.random((num_pts, 3))
        write_point_cloud(ply_path, xyz, (rgb * 255))
    xyz, rgb, normals = read_point_cloud(ply_path)

    return SceneInfo(points=xyz, colors=rgb, normals=normals,
                     train_cameras=train, test_cameras=test,
                     translate=translate, radius=radius, ply_path=ply_path)


def load_scene(path: str, images: str = "images", eval_split: bool = True,
               lod: int = 0, white_background: bool = False,
               resolution: int = -1) -> SceneInfo:
    """Auto-detect Colmap vs Blender layout (ref scene/__init__.py:45-52)."""
    if os.path.exists(os.path.join(path, "sparse")):
        return load_colmap_scene(path, images=images, eval_split=eval_split,
                                 lod=lod, resolution=resolution)
    if os.path.exists(os.path.join(path, "transforms_train.json")):
        return load_blender_scene(path, white_background=white_background,
                                  eval_split=eval_split)
    raise ValueError(f"could not infer scene type from {path}")
