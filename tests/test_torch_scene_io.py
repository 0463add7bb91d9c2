"""PyTorch port against the JAX reference in scene and snapshot I/O (CPU):
the port's stdlib PNG reader and writer against Pillow, the COLMAP and PLY
readers and writers, the COLMAP and Blender loaders on tiny scenes on disk,
and the model snapshot (`point_cloud.ply`, `checkpoint.pth`) of a state
converted from JAX. Bytes and integers are held exact; so are the loaders'
float arrays, which both packages compute with the same numpy code."""

import json
import pickle
import shutil
import struct
import sys
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from contextgs_tpu import config as jcfg
from contextgs_tpu.models import state as jst
from contextgs_tpu.scene import colmap as jcolmap
from contextgs_tpu.scene import dataset_readers as jdr
from contextgs_tpu.scene import ply_io as jply
from contextgs_tpu.scene import snapshot as jsnap
from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch import convert
from contextgs_tpu_torch.models import state as tst
from contextgs_tpu_torch.scene import colmap as tcolmap
from contextgs_tpu_torch.scene import dataset_readers as tdr
from contextgs_tpu_torch.scene import ply_io as tply
from contextgs_tpu_torch.scene import snapshot as tsnap
from contextgs_tpu_torch.utils import png

torch.set_num_threads(1)

CFG_KW = dict(feat_dim=8, n_offsets=4, voxel_size=0.05)


# ---------------------------------------------------------------- PNG

def _pixels(mode, kind, rng, h=37, w=45):
    """A test image of Pillow `mode` ("L", "RGB", "RGBA") whose rows suit
    different PNG filters."""
    y, x = np.mgrid[0:h, 0:w]
    base = {
        "noise": rng.integers(0, 256, (h, w, 4)),
        "gradients": np.stack([x * 5, y * 6, x * 3 + y * 5, x * y], -1),
        "smooth": 128 + 100 * np.sin(x / 7.0 + np.arange(4)[:, None, None]
                                     ).transpose(1, 2, 0)
        * np.cos(y / 5.0)[..., None],
    }[kind].astype(np.int64) % 256
    channels = {"L": 1, "RGB": 3, "RGBA": 4}[mode]
    img = base[..., :channels].astype(np.uint8)
    return img[..., 0] if mode == "L" else img


def _filtered_png(img, filters):
    """PNG bytes of uint8 `img` with row y filtered by filters[y % len]:
    each of the five filter types written by the encoder the PNG
    specification defines."""
    arr = img[..., None] if img.ndim == 2 else img
    h, w, c = arr.shape
    raw = arr.reshape(h, w * c).astype(np.int64)
    out = bytearray()
    for yy in range(h):
        t = filters[yy % len(filters)]
        line = raw[yy]
        prev = raw[yy - 1] if yy else np.zeros_like(line)
        a = np.concatenate([np.zeros(c, np.int64), line[:-c]])
        cc = np.concatenate([np.zeros(c, np.int64), prev[:-c]])
        b = prev
        pa, pb, pc = np.abs(b - cc), np.abs(a - cc), np.abs(a + b - 2 * cc)
        paeth = np.where((pa <= pb) & (pa <= pc), a,
                         np.where(pb <= pc, b, cc))
        pred = [0, a, b, (a + b) // 2, paeth][t]
        out.append(t)
        out += ((line - pred) % 256).astype(np.uint8).tobytes()
    color = {1: 0, 3: 2, 4: 6}[c]
    return (png.SIGNATURE
            + png._chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, color,
                                              0, 0, 0))
            + png._chunk(b"IDAT", zlib.compress(bytes(out)))
            + png._chunk(b"IEND", b""))


@pytest.mark.parametrize("mode", ["L", "RGB", "RGBA"])
def test_png_reader_matches_pillow(mode, tmp_path):
    """Pillow's PNGs (its adaptive filters) and PNGs with every filter type
    on its rows read as np.asarray(Image.open(p)) reads them."""
    rng = np.random.default_rng(0)
    for kind in ("noise", "gradients", "smooth"):
        img = _pixels(mode, kind, rng)
        path = str(tmp_path / f"pil_{kind}.png")
        Image.fromarray(img).save(path)
        want = np.asarray(Image.open(path))
        got = png.read_png(path)
        assert got.dtype == want.dtype and got.shape == want.shape
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(got, img)
        for filters in ([0], [1], [2], [3], [4], [0, 1, 2, 3, 4],
                        [4, 3, 2, 1]):
            path = tmp_path / f"f{''.join(map(str, filters))}_{kind}.png"
            path.write_bytes(_filtered_png(img, filters))
            np.testing.assert_array_equal(png.read_png(str(path)),
                                          np.asarray(Image.open(path)))
            np.testing.assert_array_equal(png.read_png(str(path)), img)


@pytest.mark.parametrize("channels", [3, 4])
def test_png_writer_read_by_pillow(channels, tmp_path):
    img = np.random.default_rng(1).integers(
        0, 256, (23, 31, channels), dtype=np.uint8)
    path = str(tmp_path / "own.png")
    png.write_png(path, img)
    with Image.open(path) as im:
        assert im.mode == ("RGB" if channels == 3 else "RGBA")
        np.testing.assert_array_equal(np.asarray(im), img)
    np.testing.assert_array_equal(png.read_png(path), img)
    with pytest.raises(ValueError, match="uint8"):
        png.encode_png(img.astype(np.float32))


def test_png_reader_refuses_other_variants(tmp_path):
    """16-bit, palette, grey+alpha and interlaced PNGs raise, naming the
    file; so do a bad CRC and a file that is no PNG."""
    rng = np.random.default_rng(2)
    cases = {
        "palette": Image.fromarray(_pixels("L", "noise", rng)).convert("P"),
        "grey_alpha": Image.fromarray(_pixels("RGBA", "noise", rng))
        .convert("LA"),
        "sixteen_bit": Image.fromarray(
            rng.integers(0, 65536, (8, 8), dtype=np.uint16)),
    }
    for name, im in cases.items():
        path = str(tmp_path / f"{name}.png")
        im.save(path)
        with pytest.raises(ValueError, match=f"{name}.png: unsupported"):
            png.read_png(path)
    good = png.encode_png(_pixels("RGB", "noise", rng))
    ihdr = bytearray(good[16:29])                 # IHDR body
    ihdr[12] = 1                                  # Adam7 interlace
    interlaced = (good[:8] + png._chunk(b"IHDR", bytes(ihdr)) + good[33:])
    (tmp_path / "interlaced.png").write_bytes(interlaced)
    with pytest.raises(ValueError, match="interlaced.png: unsupported"):
        png.read_png(str(tmp_path / "interlaced.png"))
    bad = bytearray(good)
    bad[40] ^= 0xFF                               # inside the IDAT body
    (tmp_path / "bad_crc.png").write_bytes(bytes(bad))
    with pytest.raises(ValueError, match="bad_crc.png: CRC"):
        png.read_png(str(tmp_path / "bad_crc.png"))
    (tmp_path / "not.png").write_bytes(b"GIF89a")
    with pytest.raises(ValueError, match="not.png: not a PNG"):
        png.read_png(str(tmp_path / "not.png"))


# ------------------------------------------------------------- COLMAP

def _colmap_model(mod, rng, n_images=5):
    cams = {1: mod.ColmapCamera(1, "PINHOLE", 40, 30,
                                np.array([35.0, 36.0, 20.0, 15.0])),
            2: mod.ColmapCamera(2, "SIMPLE_PINHOLE", 48, 32,
                                np.array([40.0, 24.0, 16.0]))}
    images = {}
    for i in range(1, n_images + 1):
        q = rng.normal(size=4)
        images[i] = mod.ColmapImage(i, q / np.linalg.norm(q),
                                    rng.normal(size=3), 1 + i % 2,
                                    f"im_{(7 * i) % 11:03d}.png")
    return cams, images


def test_colmap_binary_matches_jax(tmp_path):
    rng = np.random.default_rng(3)
    xyz = rng.normal(size=(50, 3))
    rgb = rng.integers(0, 256, (50, 3), dtype=np.uint8)
    for mod, sub in ((jcolmap, "jax"), (tcolmap, "port")):
        d = tmp_path / sub
        d.mkdir()
        cams, images = _colmap_model(mod, np.random.default_rng(4))
        mod.write_cameras_binary(cams, str(d / "cameras.bin"))
        mod.write_images_binary(images, str(d / "images.bin"))
        mod.write_points3d_binary(xyz, rgb, str(d / "points3D.bin"))
    for name in ("cameras.bin", "images.bin", "points3D.bin"):
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name
    d = str(tmp_path / "port")
    _same_colmap(
        (jcolmap.read_cameras_binary(f"{d}/cameras.bin"),
         jcolmap.read_images_binary(f"{d}/images.bin"),
         jcolmap.read_points3d_binary(f"{d}/points3D.bin")),
        (tcolmap.read_cameras_binary(f"{d}/cameras.bin"),
         tcolmap.read_images_binary(f"{d}/images.bin"),
         tcolmap.read_points3d_binary(f"{d}/points3D.bin")))


def _same_colmap(want, got):
    (jc, ji, jp), (tc, ti, tp) = want, got
    assert jc.keys() == tc.keys() and ji.keys() == ti.keys()
    for k in jc:
        assert (jc[k].model, jc[k].width, jc[k].height) == (
            tc[k].model, tc[k].width, tc[k].height)
        np.testing.assert_array_equal(jc[k].params, tc[k].params)
    for k in ji:
        assert (ji[k].camera_id, ji[k].name) == (ti[k].camera_id, ti[k].name)
        np.testing.assert_array_equal(ji[k].qvec, ti[k].qvec)
        np.testing.assert_array_equal(ji[k].tvec, ti[k].tvec)
    for a, b in zip(jp, tp):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


def _write_colmap_text(d, rng):
    (d / "cameras.txt").write_text(
        "# Camera list\n1 PINHOLE 40 30 35.5 36.25 20 15\n"
        "2 SIMPLE_PINHOLE 48 32 40.125 24 16\n")
    lines = ["# Image list", "#   IMAGE_ID, QW, ..."]
    for i in range(1, 6):
        q = rng.normal(size=4)
        q /= np.linalg.norm(q)
        t = rng.normal(size=3)
        lines.append(f"{i} {' '.join(repr(float(v)) for v in (*q, *t))} "
                     f"{1 + i % 2} im_{(7 * i) % 11:03d}.png")
        lines.append("1.5 2.5 -1 3.0 4.0 7")       # 2D points, skipped
    (d / "images.txt").write_text("\n".join(lines) + "\n")
    pts = ["# 3D point list"]
    for i in range(40):
        x = rng.normal(size=3)
        c = rng.integers(0, 256, 3)
        pts.append(f"{i + 1} {' '.join(repr(float(v)) for v in x)} "
                   f"{c[0]} {c[1]} {c[2]} {float(rng.random())!r} 1 2")
    (d / "points3D.txt").write_text("\n".join(pts) + "\n")


def test_colmap_text_matches_jax(tmp_path):
    _write_colmap_text(tmp_path, np.random.default_rng(5))
    d = str(tmp_path)
    _same_colmap(
        (jcolmap.read_cameras_text(f"{d}/cameras.txt"),
         jcolmap.read_images_text(f"{d}/images.txt"),
         jcolmap.read_points3d_text(f"{d}/points3D.txt")),
        (tcolmap.read_cameras_text(f"{d}/cameras.txt"),
         tcolmap.read_images_text(f"{d}/images.txt"),
         tcolmap.read_points3d_text(f"{d}/points3D.txt")))


# ---------------------------------------------------------------- PLY

def test_ply_matches_jax(tmp_path):
    """write_ply and write_point_cloud byte-identical; binary and ascii
    files read into equal arrays."""
    rng = np.random.default_rng(6)
    fields = {"x": rng.normal(size=30).astype(np.float32),
              "flag": rng.integers(0, 256, 30).astype(np.uint8),
              "count": rng.integers(-1000, 1000, 30).astype(np.int32),
              "w": rng.normal(size=30)}
    xyz, rgb = rng.normal(size=(30, 3)), rng.uniform(0, 255, (30, 3))
    for mod, sub in ((jply, "jax"), (tply, "port")):
        d = tmp_path / sub
        d.mkdir()
        mod.write_ply(str(d / "fields.ply"), fields)
        mod.write_point_cloud(str(d / "cloud.ply"), xyz, rgb)
    for name in ("fields.ply", "cloud.ply"):
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name
    ascii_ply = tmp_path / "ascii.ply"
    ascii_ply.write_text(
        "ply\nformat ascii 1.0\ncomment made by hand\nelement vertex 3\n"
        "property float x\nproperty float y\nproperty float z\n"
        "property uchar red\nproperty uchar green\nproperty uchar blue\n"
        "element face 0\nproperty list uchar int vertex_indices\n"
        "end_header\n0.5 1.25 -2 10 20 30\n1e-3 2 3 0 255 7\n-4 5.5 6 1 2 3\n")
    for path in (str(ascii_ply), str(tmp_path / "port" / "fields.ply"),
                 str(tmp_path / "port" / "cloud.ply")):
        want, got = jply.read_ply(path), tply.read_ply(path)
        assert list(want) == list(got)
        for k in want:
            assert want[k].dtype == got[k].dtype
            np.testing.assert_array_equal(want[k], got[k])
    for a, b in zip(jply.read_point_cloud(str(ascii_ply)),
                    tply.read_point_cloud(str(ascii_ply))):
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------ loaders

def _colmap_scene(root, binary=True, n_images=10, jpeg_one=False):
    """A tiny COLMAP scene on disk: PNGs written by Pillow (RGB and RGBA),
    binary or text model."""
    rng = np.random.default_rng(8)
    sparse = root / "sparse" / "0"
    sparse.mkdir(parents=True)
    (root / "images").mkdir()
    cams, images = _colmap_model(tcolmap, rng, n_images)
    for i, im in images.items():
        w, h = cams[im.camera_id].width, cams[im.camera_id].height
        mode = "RGBA" if i % 3 == 0 else "RGB"
        pix = rng.integers(0, 256, (h, w, len(mode)), dtype=np.uint8)
        if jpeg_one and i == 1:
            im.name = im.name.replace(".png", ".jpg")
            Image.fromarray(pix[..., :3]).save(root / "images" / im.name,
                                               quality=90)
        else:
            Image.fromarray(pix, mode).save(root / "images" / im.name)
    xyz = rng.normal(size=(60, 3))
    rgb = rng.integers(0, 256, (60, 3), dtype=np.uint8)
    if binary:
        tcolmap.write_cameras_binary(cams, str(sparse / "cameras.bin"))
        tcolmap.write_images_binary(images, str(sparse / "images.bin"))
        tcolmap.write_points3d_binary(xyz, rgb, str(sparse / "points3D.bin"))
    else:
        _write_colmap_text(sparse, rng)
    return root


def _same_cameras(want, got):
    assert len(want) == len(got)
    for a, b in zip(want, got):
        assert (a.uid, a.image_name, a.width, a.height) == (
            b.uid, b.image_name, b.width, b.height)
        assert (a.fov_x, a.fov_y) == (b.fov_x, b.fov_y)
        for f in ("R", "T", "world_view", "full_proj", "camera_center",
                  "image"):
            x, y = getattr(a, f), getattr(b, f)
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)


def _same_scene(want, got, jax_root, port_root):
    _same_cameras(want.train_cameras, got.train_cameras)
    _same_cameras(want.test_cameras, got.test_cameras)
    np.testing.assert_array_equal(want.translate, got.translate)
    assert want.radius == got.radius
    for f in ("points", "colors", "normals"):
        np.testing.assert_array_equal(getattr(want, f), getattr(got, f))
    rel = str(want.ply_path)[len(str(jax_root)):]
    assert str(got.ply_path)[len(str(port_root)):] == rel
    assert ((jax_root / rel.lstrip("/")).read_bytes()
            == (port_root / rel.lstrip("/")).read_bytes())


@pytest.mark.parametrize("case", ["binary_every8th", "text_lod", "resize"])
def test_load_colmap_scene_matches_jax(case, tmp_path):
    """The loader's cameras, images, split, normalization and point cloud
    (and the points3D.ply cache it writes) equal JAX's; `-r 2` resizes
    through Pillow as JAX does."""
    kw = dict(binary_every8th=dict(), text_lod=dict(lod=3),
              resize=dict(resolution=2))[case]
    jax_root = _colmap_scene(tmp_path / "jax", binary=case != "text_lod")
    port_root = tmp_path / "port"
    shutil.copytree(jax_root, port_root)
    want = jdr.load_colmap_scene(str(jax_root), **kw)
    got = tdr.load_colmap_scene(str(port_root), **kw)
    _same_scene(want, got, jax_root, port_root)
    assert len(got.test_cameras) == (4 if case == "text_lod" else 2)


def test_load_blender_scene_matches_jax(tmp_path):
    """RGBA PNGs composited on the background, the OpenGL→COLMAP flip, both
    fov conventions, and the seeded random point cloud."""
    rng = np.random.default_rng(9)
    jax_root = tmp_path / "jax"
    jax_root.mkdir()
    for split, n in (("train", 3), ("test", 2)):
        frames = []
        for i in range(n):
            c2w = np.eye(4)
            c2w[:3, 3] = rng.normal(size=3) * 3
            q = rng.normal(size=4)
            c2w[:3, :3] = tdr.qvec_to_rotmat(q / np.linalg.norm(q))
            name = f"{split}/r_{i}"
            (jax_root / split).mkdir(exist_ok=True)
            Image.fromarray(rng.integers(0, 256, (20, 24, 4),
                                         dtype=np.uint8), "RGBA").save(
                jax_root / f"{name}.png")
            frame = dict(file_path=name, transform_matrix=c2w.tolist())
            if split == "test":
                frame.update(fl_x=30.0, fl_y=28.0)
            frames.append(frame)
        meta = dict(frames=frames)
        if split == "train":
            meta["camera_angle_x"] = 0.69
        (jax_root / f"transforms_{split}.json").write_text(json.dumps(meta))
    port_root = tmp_path / "port"
    shutil.copytree(jax_root, port_root)
    for white in (False, True):
        want = jdr.load_blender_scene(str(jax_root), white_background=white)
        got = tdr.load_blender_scene(str(port_root), white_background=white)
        _same_scene(want, got, jax_root, port_root)
    _same_cameras(jdr.load_scene(str(jax_root)).train_cameras,
                  tdr.load_scene(str(port_root)).train_cameras)


def test_pillow_only_for_jpeg_and_resize(tmp_path, monkeypatch):
    """A JPEG reads through Pillow into JAX's array; where Pillow does not
    import, the JPEG and the resize raise naming Pillow, and a PNG scene at
    its own size loads all the same."""
    root = _colmap_scene(tmp_path / "jpeg", jpeg_one=True)
    root2 = tmp_path / "jpeg2"
    shutil.copytree(root, root2)
    want = jdr.load_colmap_scene(str(root))
    got = tdr.load_colmap_scene(str(root2))
    _same_cameras(want.train_cameras + want.test_cameras,
                  got.train_cameras + got.test_cameras)
    png_root = _colmap_scene(tmp_path / "png")
    monkeypatch.setitem(sys.modules, "PIL", None)
    with pytest.raises(ImportError, match="needs Pillow"):
        tdr.load_colmap_scene(str(root2))
    assert len(tdr.load_colmap_scene(str(png_root)).train_cameras) == 8
    with pytest.raises(ImportError, match="needs Pillow"):
        tdr.load_colmap_scene(str(png_root), resolution=2)


# ----------------------------------------------------------- snapshot

def _jax_state():
    """A reference state with non-trivial content and dead slots, and the
    same state converted to the port."""
    rng = np.random.default_rng(10)
    cj = jcfg.ModelConfig(**CFG_KW)
    model, _ = jst.init_scene_model(jax.random.PRNGKey(0),
                                    rng.uniform(-1, 1, (200, 3)), cj)
    p = model.params

    def draw(x, s=1.0):
        return jnp.asarray(rng.normal(size=x.shape) * s, jnp.float32)

    p = p._replace(anchor_feat=draw(p.anchor_feat),
                   hyper_latent=draw(p.hyper_latent),
                   offsets=draw(p.offsets, 0.3), mask_logit=draw(p.mask_logit),
                   scaling_log=draw(p.scaling_log), rotation=draw(p.rotation),
                   opacity_raw=draw(p.opacity_raw),
                   mlps=jax.tree.map(draw, p.mlps),
                   prior=jax.tree.map(draw, p.prior))
    alive = np.asarray(model.buffers.alive) & (rng.random(
        model.buffers.alive.shape) > 0.2)
    b = model.buffers._replace(alive=jnp.asarray(alive))
    ct = tcfg.ModelConfig(**CFG_KW)
    tp = convert.params_from_numpy(jax.tree.map(np.asarray, p), ct, "cpu")
    tb = convert.buffers_from_numpy(jax.tree.map(np.asarray, b), "cpu")
    return (cj, p, b), (ct, tp, tb)


def test_snapshot_matches_jax(tmp_path):
    """save_model_ply and save_networks byte-identical to JAX's for the same
    state; load_model_ply and load_networks give JAX's values back."""
    (cj, p, b), (ct, tp, tb) = _jax_state()
    extra = dict(bound_min=np.asarray(b.bound_min),
                 bound_max=np.asarray(b.bound_max), level_scales=[4.0, 16.0],
                 voxel_size=0.05, iteration=7)
    for mod, params, buffers, sub in ((jsnap, p, b, "jax"),
                                      (tsnap, tp, tb, "port")):
        d = tmp_path / sub
        mod.save_model_ply(str(d / "point_cloud.ply"), params, buffers)
        mod.save_networks(str(d / "checkpoint.pth"), params, extra=extra)
    for name in ("point_cloud.ply", "checkpoint.pth", "checkpoint.pth.meta"):
        assert ((tmp_path / "jax" / name).read_bytes()
                == (tmp_path / "port" / name).read_bytes()), name

    ply = str(tmp_path / "port" / "point_cloud.ply")
    jmodel = jsnap.load_model_ply(ply, cj, jst.SceneModel(p, b))
    tmodel = tsnap.load_model_ply(ply, ct, tst.SceneModel(tp, tb))
    n = int(np.asarray(b.alive).sum())
    assert int(tmodel.buffers.alive.sum()) == n
    for f in tst.ANCHOR_FIELDS:
        np.testing.assert_array_equal(
            getattr(tmodel.params, f).numpy(),
            np.asarray(getattr(jmodel.params, f)), err_msg=f)
        np.testing.assert_array_equal(
            getattr(tmodel.params, f)[:n].numpy(),
            np.asarray(getattr(p, f))[np.asarray(b.alive)], err_msg=f)
    for f in tst.Buffers._fields:
        np.testing.assert_array_equal(getattr(tmodel.buffers, f).numpy(),
                                      np.asarray(getattr(jmodel.buffers, f)),
                                      err_msg=f)

    mlps, prior, got_extra = tsnap.load_networks(
        str(tmp_path / "jax" / "checkpoint.pth"), ct, "cpu")
    for (name, x), w in zip(tst.net_leaves(mlps, prior).items(),
                            tst.net_leaves(tp.mlps, tp.prior).values()):
        assert torch.equal(x, w), name
    with open(tmp_path / "jax" / "checkpoint.pth.meta", "rb") as f:
        want_extra = pickle.load(f)
    assert got_extra.keys() == want_extra.keys()
    np.testing.assert_array_equal(got_extra["bound_min"],
                                  want_extra["bound_min"])
    assert got_extra["level_scales"] == want_extra["level_scales"]
