"""The port's live viewer against the JAX package's: `MiniCam`, the SIBR
wire protocol of `utils/viewer.ViewerServer` (the loopback cases of
`tests/test_viewer.py`, each run through both servers with the same client
bytes), `drivers.train.viewer_render` against the JAX driver's render of a
frame, and `drivers.train --gui` serving a frame to a client while it
trains on the CPU.

Every socket has a timeout and every thread is joined with one."""

import json
import os
import socket
import subprocess
import sys
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from contextgs_tpu import config as jcfg
from contextgs_tpu.models import state as jst
from contextgs_tpu.models.levels import build_level_maps as jax_level_maps
from contextgs_tpu.models.renderer import render as jax_render
from contextgs_tpu.scene import cameras as jcams
from contextgs_tpu.utils import viewer as jviewer
from contextgs_tpu_torch import config as tcfg
from contextgs_tpu_torch import convert
from contextgs_tpu_torch.drivers import train as train_driver
from contextgs_tpu_torch.models.state import SceneModel
from contextgs_tpu_torch.scene import cameras as tcams
from contextgs_tpu_torch.scripts import make_synth_scene
from contextgs_tpu_torch.train.loop import TrainerState
from contextgs_tpu_torch.train.optim import init_adam
from contextgs_tpu_torch.utils import viewer as tviewer

from utils_synthetic import make_test_camera

torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT = 10          # seconds a socket read or a thread join may take
W, H = 48, 40
MODEL_KW = dict(feat_dim=8, n_offsets=4, voxel_size=0.05)
SCALES = (4.37, 15.73)    # not integers: no level ties (test_torch_sharded)


def _matrices(rng):
    """A camera's transposed view and view-projection matrices, off the
    identity."""
    ang = rng.uniform(-0.5, 0.5, 3)
    rx = np.array([[1, 0, 0], [0, np.cos(ang[0]), -np.sin(ang[0])],
                   [0, np.sin(ang[0]), np.cos(ang[0])]])
    ry = np.array([[np.cos(ang[1]), 0, np.sin(ang[1])], [0, 1, 0],
                   [-np.sin(ang[1]), 0, np.cos(ang[1])]])
    return make_test_camera(width=W, height=H, R=rx @ ry,
                            T=rng.uniform(-1, 1, 3))


def test_minicam_matches_jax(rng):
    """The same matrices make the same MiniCam: matrices, camera centre,
    tangents and the device dict, whose keys are Camera's."""
    cam = _matrices(rng)
    kw = dict(width=W, height=H, fov_x=cam.fov_x, fov_y=0.8, znear=0.01,
              zfar=100.0, world_view=cam.world_view, full_proj=cam.full_proj)
    got, want = tcams.MiniCam(**kw), jcams.MiniCam(**kw)
    for name in ("world_view", "full_proj", "camera_center"):
        np.testing.assert_array_equal(getattr(got, name),
                                      getattr(want, name), name)
    np.testing.assert_allclose(got.camera_center, cam.camera_center,
                               atol=1e-5)
    assert (got.tanfovx, got.tanfovy) == (want.tanfovx, want.tanfovy)
    gd, wd = got.as_device_dict(), want.as_device_dict()
    assert list(gd) == list(wd)
    port_cam = tcams.Camera(uid=0, colmap_id=0, R=np.eye(3), T=np.zeros(3),
                            fov_x=1.0, fov_y=1.0, image=None, width=W,
                            height=H)
    assert list(gd) == list(port_cam.as_device_dict())
    for k in gd:
        np.testing.assert_array_equal(gd[k], wd[k], k)
        assert np.asarray(gd[k]).dtype == np.float32, k


# ------------------------------------------------------------ the protocol

def _client_message(cam, train=True, keep_alive=False, res=None,
                    scaling=1.0):
    """The JSON message a SIBR client sends for `cam`: matrices in its
    flipped-axis convention (columns 1, 2 of the view and column 1 of the
    view-projection negated)."""
    wv = cam.world_view.copy()
    wv[:, 1] = -wv[:, 1]
    wv[:, 2] = -wv[:, 2]
    vp = cam.full_proj.copy()
    vp[:, 1] = -vp[:, 1]
    w, h = res if res is not None else (cam.width, cam.height)
    return dict(resolution_x=w, resolution_y=h, train=train,
                fov_x=cam.fov_x, fov_y=cam.fov_y, z_near=cam.znear,
                z_far=cam.zfar, shs_python=False, rot_scale_python=False,
                keep_alive=keep_alive, scaling_modifier=scaling,
                view_matrix=[float(x) for x in wv.reshape(-1)],
                view_projection_matrix=[float(x) for x in vp.reshape(-1)])


def _send(sock, msg):
    data = json.dumps(msg).encode("utf-8")
    sock.sendall(len(data).to_bytes(4, "little") + data)


def _recv_exact(sock, n):
    buf = b""
    while len(buf) < n:
        chunk = sock.recv(n - len(buf))
        assert chunk, "server closed"
        buf += chunk
    return buf


def _recv_verify(sock):
    return _recv_exact(sock, int.from_bytes(_recv_exact(sock, 4), "little"))


def _transcript(module, case, cam, frame):
    """One case through `module`'s server: → (bytes the client received,
    what each receive() returned, what each render call saw)."""
    server = module.ViewerServer("127.0.0.1", 0)
    received, calls, got = [], [], []
    receive = server.receive

    def logged_receive():
        out = receive()
        received.append(out)
        return out

    server.receive = logged_receive

    def render_rgb(mc, scaling):
        calls.append((mc, scaling))
        return frame

    client = socket.create_connection(("127.0.0.1", server.port),
                                      timeout=TIMEOUT)
    try:
        if case == "disconnect":
            client.close()
            server.poll(render_rgb, "x", 1, 10)     # accept, read fails
            assert server.conn is None
            return got, received, calls
        args = ((render_rgb, "/data/scene", 100, 30_000) if case == "frame"
                else (render_rgb, "x", 5, 10))
        t = threading.Thread(target=server.poll, args=args)
        t.start()
        if case == "keepalive":
            _send(client, _client_message(cam, train=False, res=(0, 0)))
            got.append(_recv_verify(client))
            assert not calls         # a keep-alive renders nothing
        _send(client, _client_message(cam, scaling=0.5))
        got.append(_recv_exact(client, cam.height * cam.width * 3))
        got.append(_recv_verify(client))
        t.join(timeout=TIMEOUT)
        assert not t.is_alive()
        return got, received, calls
    finally:
        client.close()
        server.close()


@pytest.mark.parametrize("case", ["frame", "keepalive", "disconnect"])
def test_viewer_protocol_matches_jax(case, rng):
    """The three loopback cases of tests/test_viewer.py (frame + verify,
    keep-alive, a dropped client recovered) through both packages'
    servers: the client receives the same bytes, and the receive() results
    and the render callback's (MiniCam, scaling) are the same."""
    cam = _matrices(rng)
    frame = np.linspace(-0.1, 1.1, H * W * 3,
                        dtype=np.float32).reshape(H, W, 3)
    got = _transcript(tviewer, case, cam, frame)
    want = _transcript(jviewer, case, cam, frame)
    assert got[0] == want[0]
    assert len(got[1]) == len(want[1])
    for a, b in zip(got[1] + got[2], want[1] + want[2]):
        mc_a, mc_b = a[0], b[0]
        assert (mc_a is None) == (mc_b is None)
        assert a[1:] == b[1:]
        if mc_a is not None:
            for name in ("width", "height", "fov_x", "fov_y", "znear",
                         "zfar"):
                assert getattr(mc_a, name) == getattr(mc_b, name), name
            for name in ("world_view", "full_proj", "camera_center"):
                np.testing.assert_array_equal(getattr(mc_a, name),
                                              getattr(mc_b, name), name)
    if case != "disconnect":
        img, verify = got[0][-2:]
        assert img == (np.clip(frame, 0, 1) * 255 + 0.5).astype(
            np.uint8).tobytes()
        assert verify == (b"/data/scene" if case == "frame" else b"x")
        mc, scaling = got[2][0]
        np.testing.assert_allclose(mc.world_view, cam.world_view, atol=1e-6)
        np.testing.assert_allclose(mc.full_proj, cam.full_proj, atol=1e-6)
        assert scaling == 0.5 and len(got[2]) == 1


# ------------------------------------------------------------ the frames

def _model():
    """A seeded JAX model in front of the test camera (the sharded test's
    recipe), its configs, and the port's copy of it."""
    jc = jcfg.TrainConfig(model=jcfg.ModelConfig(**MODEL_KW),
                          pipe=jcfg.PipelineConfig(backend="reference",
                                                   chunk_size=128))
    tc = tcfg.TrainConfig(model=tcfg.ModelConfig(**MODEL_KW))
    rng = np.random.default_rng(5)
    pts = rng.uniform(-0.7, 0.7, (300, 3)) + np.array([0, 0, 2.5])
    model, voxel = jst.init_scene_model(jax.random.PRNGKey(0), pts,
                                        jc.model)
    p = model.params._replace(
        anchor_feat=jax.random.normal(jax.random.PRNGKey(1),
                                      model.params.anchor_feat.shape) * 0.3,
        offsets=jax.random.normal(jax.random.PRNGKey(2),
                                  model.params.offsets.shape) * 0.1)
    b = model.buffers
    params = convert.params_from_numpy(jax.tree.map(np.asarray, p),
                                       tc.model, "cpu")
    buffers = convert.buffers_from_numpy(jax.tree.map(np.asarray, b), "cpu")
    ts = TrainerState(model=SceneModel(params, buffers),
                      adam=init_adam(params), voxel_size=voxel,
                      spatial_lr_scale=1.0, generator=torch.Generator())
    return jc, tc, p, b, voxel, ts


def _minicams(rng):
    cam = _matrices(rng)
    kw = dict(width=W, height=H, fov_x=cam.fov_x, fov_y=cam.fov_y,
              znear=0.01, zfar=100.0, world_view=cam.world_view,
              full_proj=cam.full_proj)
    return tcams.MiniCam(**kw), jcams.MiniCam(**kw)


def _jax_frame(jc, p, b, voxel, mc, phase, scales, smod):
    """The JAX driver's viewer frame: train.py's jitted render_rgb."""
    def fn(params, buffers, cam, smod_):
        maps = None
        if phase == "context":
            maps = jax_level_maps(jst.get_anchor(params, buffers),
                                  buffers.alive, voxel, scales,
                                  jc.model.level_num)
        out = jax_render(params, buffers, jc.model, jc.opt, jc.pipe, cam,
                         mc.width, mc.height, jnp.zeros(3, jnp.float32),
                         jax.random.PRNGKey(0), phase=phase, training=False,
                         maps=maps, budget=1 << 16, scale_modifier=smod_)
        return jnp.clip(out.image, 0.0, 1.0).transpose(1, 2, 0)

    cam = {k: jnp.asarray(v) for k, v in mc.as_device_dict().items()}
    return np.asarray(jax.jit(fn)(p, b, cam, jnp.float32(smod)))


@pytest.mark.parametrize("phase, smod", [("plain", 1.0), ("context", 1.0),
                                         ("context", 0.5)],
                         ids=["plain", "context", "context_half_scale"])
def test_viewer_render_matches_jax(phase, smod, rng):
    """`viewer_render` against the JAX driver's frame of the same model and
    MiniCam, within 1e-5: the plain phase, and the context phase (level
    maps of the quantized anchors at non-integer scales), also at a
    scaling modifier of 0.5."""
    jc, tc, p, b, voxel, ts = _model()
    it = dict(plain=100, context=20_000)[phase]
    ts.level_scales = list(SCALES)
    tmc, jmc = _minicams(rng)
    got = train_driver.viewer_render(ts, it, tc, tmc, smod)
    want = _jax_frame(jc, p, b, voxel, jmc, phase, SCALES, smod)
    assert tuple(got.shape) == (H, W, 3)
    assert float(want.max()) > 0.05
    np.testing.assert_allclose(got.numpy(), want, atol=1e-5)
    if smod != 1.0:
        full = train_driver.viewer_render(ts, it, tc, tmc, 1.0)
        assert float((full - got).abs().max()) > 1e-3


def test_viewer_render_noise_phase(rng):
    """The noise phase draws from each framework's own generator, so only
    shape, range and seed-determinism are held; a context step whose level
    scales are not searched yet renders the noise phase."""
    _, tc, _, _, _, ts = _model()
    tmc, _ = _minicams(rng)
    a = train_driver.viewer_render(ts, 5000, tc, tmc)
    b = train_driver.viewer_render(ts, 5000, tc, tmc)
    assert tuple(a.shape) == (H, W, 3)
    assert float(a.min()) >= 0.0 and float(a.max()) <= 1.0
    assert float(a.max()) > 0.05
    assert torch.equal(a, b)
    assert ts.level_scales is None
    assert torch.equal(train_driver.viewer_render(ts, 20_000, tc, tmc), a)
    plain = train_driver.viewer_render(ts, 100, tc, tmc)
    assert not torch.equal(plain, a)


# ------------------------------------------------------ --gui in the driver

def test_train_driver_serves_a_frame(tmp_path):
    """`drivers.train --gui --port 0 --force_cpu` on the tiny synthetic
    scene: a client asks for one 48x40 frame while it trains, then lets
    training continue (train=True, keep_alive=False) and hangs up; the run
    exits 0 and the frame arrived whole, followed by the verify string
    (the scene's path)."""
    scene, model = tmp_path / "scene", tmp_path / "model"
    assert make_synth_scene.main(["--out", str(scene), "--res", "64",
                                  "--cams", "8", "--gauss", "2000",
                                  "--points", "300", "--force_cpu"]) == 0
    cam = make_test_camera(width=W, height=H, T=np.array([0.0, 0.0, 4.0]))
    err = open(tmp_path / "stderr.txt", "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "contextgs_tpu_torch.drivers.train", "-s",
         str(scene), "-m", str(model), "--iterations", "30", "--noise_from",
         "10", "--context_from", "20", "--start_stat", "2", "--update_from",
         "4", "--update_interval", "10", "--update_until", "15",
         "--n_offsets", "4", "--skip_codec", "--no_tensorboard", "--gui",
         "--port", "0", "--force_cpu"],
        cwd=REPO, stdout=subprocess.DEVNULL, stderr=err,
        env=dict(os.environ, OMP_NUM_THREADS="1"))
    try:
        log = model / "outputs.log"
        deadline = time.monotonic() + 120
        port = None
        while port is None and time.monotonic() < deadline:
            text = log.read_text() if log.exists() else ""
            if "viewer listening on " in text:
                port = int(text.split("viewer listening on ")[1]
                           .split()[0].rsplit(":", 1)[1])
            elif proc.poll() is not None:
                break
            time.sleep(0.05)
        assert port, (tmp_path / "stderr.txt").read_text()[-3000:]
        client = socket.create_connection(("127.0.0.1", port),
                                          timeout=60)
        try:
            _send(client, _client_message(cam, train=False))
            img = _recv_exact(client, W * H * 3)
            verify = _recv_verify(client)
            _send(client, _client_message(cam, train=True, keep_alive=False,
                                          res=(0, 0)))
            assert _recv_verify(client) == verify
        finally:
            client.close()
        assert proc.wait(timeout=300) == 0, \
            (tmp_path / "stderr.txt").read_text()[-3000:]
    finally:
        if proc.poll() is None:
            proc.kill()
            proc.wait(timeout=30)
        err.close()
    assert len(img) == W * H * 3
    assert verify == os.path.abspath(scene).encode("ascii")
    assert max(img) > 0
    assert "training done" in log.read_text()
