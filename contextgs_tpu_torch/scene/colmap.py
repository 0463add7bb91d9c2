"""COLMAP sparse-reconstruction readers (binary and text) and binary
writers, pure numpy: the port's own copy of `contextgs_tpu/scene/colmap.py`.

The public COLMAP layout; the writers write what the JAX package's write,
byte for byte.
"""

from __future__ import annotations

import os
import struct
from dataclasses import dataclass

import numpy as np

# camera model id → (name, num_params); params layouts follow COLMAP docs.
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray


@dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray   # (w,x,y,z)
    tvec: np.ndarray
    camera_id: int
    name: str


def _read(fid, fmt: str):
    return struct.unpack(fmt, fid.read(struct.calcsize(fmt)))


def read_cameras_binary(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            cam_id, model_id, w, h = _read(f, "<iiQQ")
            name, n_params = CAMERA_MODELS[model_id]
            params = np.array(_read(f, f"<{n_params}d"))
            cams[cam_id] = ColmapCamera(cam_id, name, int(w), int(h), params)
    return cams


def read_cameras_text(path: str) -> dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            cam_id, model = int(parts[0]), parts[1]
            cams[cam_id] = ColmapCamera(
                cam_id, model, int(parts[2]), int(parts[3]),
                np.array([float(p) for p in parts[4:]]))
    return cams


def read_images_binary(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            img_id = _read(f, "<i")[0]
            qvec = np.array(_read(f, "<4d"))
            tvec = np.array(_read(f, "<3d"))
            cam_id = _read(f, "<i")[0]
            name = b""
            while (c := f.read(1)) != b"\x00":
                name += c
            (n_pts,) = _read(f, "<Q")
            f.seek(24 * n_pts, os.SEEK_CUR)  # skip 2D points (x,y double + int64 id)
            images[img_id] = ColmapImage(img_id, qvec, tvec, cam_id,
                                         name.decode("utf-8"))
    return images


def read_images_text(path: str) -> dict[int, ColmapImage]:
    images = {}
    with open(path) as f:
        lines = [ln.strip() for ln in f
                 if ln.strip() and not ln.strip().startswith("#")]
    # alternating lines: image header / 2D point list
    for header in lines[0::2]:
        parts = header.split()
        img_id = int(parts[0])
        qvec = np.array([float(x) for x in parts[1:5]])
        tvec = np.array([float(x) for x in parts[5:8]])
        images[img_id] = ColmapImage(img_id, qvec, tvec, int(parts[8]), parts[9])
    return images


def read_points3d_binary(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Returns (xyz [N,3] f64, rgb [N,3] u8, error [N] f64)."""
    xyzs, rgbs, errs = [], [], []
    with open(path, "rb") as f:
        (n,) = _read(f, "<Q")
        for _ in range(n):
            _, x, y, z, r, g, b, err = _read(f, "<QdddBBBd")
            (track_len,) = _read(f, "<Q")
            f.seek(8 * track_len, os.SEEK_CUR)
            xyzs.append((x, y, z))
            rgbs.append((r, g, b))
            errs.append(err)
    return (np.array(xyzs).reshape(-1, 3), np.array(rgbs, dtype=np.uint8).reshape(-1, 3),
            np.array(errs))


def read_points3d_text(path: str) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    xyzs, rgbs, errs = [], [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            p = line.split()
            xyzs.append([float(v) for v in p[1:4]])
            rgbs.append([int(v) for v in p[4:7]])
            errs.append(float(p[7]))
    return (np.array(xyzs).reshape(-1, 3), np.array(rgbs, dtype=np.uint8).reshape(-1, 3),
            np.array(errs))


def write_cameras_binary(cams: dict[int, ColmapCamera], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for cam in cams.values():
            mid = CAMERA_MODEL_IDS[cam.model]
            f.write(struct.pack("<iiQQ", cam.id, mid, cam.width, cam.height))
            f.write(struct.pack(f"<{len(cam.params)}d", *cam.params))


def write_images_binary(images: dict[int, ColmapImage], path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(images)))
        for im in images.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<4d", *im.qvec))
            f.write(struct.pack("<3d", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            f.write(struct.pack("<Q", 0))


def write_points3d_binary(xyz: np.ndarray, rgb: np.ndarray, path: str) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(xyz)))
        for i in range(len(xyz)):
            f.write(struct.pack("<QdddBBBd", i, *xyz[i], *rgb[i].astype(np.uint8), 0.0))
            f.write(struct.pack("<Q", 0))
