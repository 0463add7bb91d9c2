"""Live-viewer socket server, the SIBR remote-viewer wire protocol (port of
`contextgs_tpu/utils/viewer.py`). The protocol is unchanged, so the stock
SIBR remote viewer connects to a training run of either package:

  client → server : 4-byte LE length + UTF-8 JSON camera message
  server → client : raw RGB888 bytes (H·W·3, row-major) when a frame was
                    rendered, then 4-byte LE length + ASCII "verify" string
                    (the scene source path).

Camera message fields: resolution_x/y, train, fov_x/fov_y, z_near/z_far,
shs_python, rot_scale_python, keep_alive, scaling_modifier, view_matrix and
view_projection_matrix (16 floats each, row-major of the transposed
matrices). Columns 1 and 2 of the view matrix and column 1 of the
view-projection matrix are negated on receipt (the viewer uses a flipped
Y/Z convention). A zero resolution is a keep-alive: nothing is rendered.

The server is free of torch: the render callback returns an [H, W, 3]
frame that `np.asarray` takes (the driver moves it to the host), so a
render failure is logged as such before the client is dropped.
"""

from __future__ import annotations

import json
import logging
import socket
import traceback
from typing import Callable, Optional, Tuple

import numpy as np

from contextgs_tpu_torch.scene.cameras import MiniCam

log = logging.getLogger("contextgs_tpu_torch")

__all__ = ["ViewerServer"]


def _recv_exact(conn: socket.socket, n: int) -> bytes:
    buf = b""
    while len(buf) < n:
        chunk = conn.recv(n - len(buf))
        if not chunk:
            raise ConnectionError("viewer client closed the connection")
        buf += chunk
    return buf


class ViewerServer:
    """Non-blocking accept / blocking per-message server for one GUI client."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.host = host
        self.port = port
        self.conn: Optional[socket.socket] = None
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self.listener.bind((host, port))
        # port=0 lets the OS pick; surface the real one
        self.port = self.listener.getsockname()[1]
        self.listener.listen()
        self.listener.settimeout(0)

    def try_connect(self) -> bool:
        """Accept a pending client, if any (never blocks)."""
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def receive(self) -> Tuple[Optional[MiniCam], bool, bool, bool, bool,
                               float]:
        """Read one camera message → (cam|None, do_training, shs_python,
        rot_scale_python, keep_alive, scaling_modifier); cam is None for a
        keep-alive."""
        n = int.from_bytes(_recv_exact(self.conn, 4), "little")
        msg = json.loads(_recv_exact(self.conn, n).decode("utf-8"))
        width, height = msg["resolution_x"], msg["resolution_y"]
        if width == 0 or height == 0:
            return None, False, False, False, False, 1.0
        wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] = -wv[:, 1]
        wv[:, 2] = -wv[:, 2]
        vp = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        vp[:, 1] = -vp[:, 1]
        cam = MiniCam(width=width, height=height,
                      fov_x=msg["fov_x"], fov_y=msg["fov_y"],
                      znear=msg["z_near"], zfar=msg["z_far"],
                      world_view=wv, full_proj=vp)
        return (cam, bool(msg["train"]), bool(msg["shs_python"]),
                bool(msg["rot_scale_python"]), bool(msg["keep_alive"]),
                float(msg["scaling_modifier"]))

    def send(self, image_bytes: Optional[bytes], verify: str) -> None:
        if image_bytes is not None:
            self.conn.sendall(image_bytes)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def drop(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            except OSError:
                pass
            self.conn = None

    def poll(self, render_rgb: Callable[[MiniCam, float], np.ndarray],
             source_path: str, iteration: int, max_iterations: int) -> None:
        """One train-loop visit: accept a client if none, then serve frames
        until the client asks training to continue.

        `render_rgb(cam, scaling_modifier)` returns an [H,W,3] float frame
        in [0,1]."""
        if self.conn is None:
            self.try_connect()
        while self.conn is not None:
            try:
                (cam, do_training, _shs, _rot, keep_alive,
                 scaling_mod) = self.receive()
                img_bytes = None
                if cam is not None:
                    frame = np.asarray(render_rgb(cam, scaling_mod))
                    img_bytes = (np.clip(frame, 0.0, 1.0) * 255 + 0.5).astype(
                        np.uint8).tobytes()
                self.send(img_bytes, source_path)
                if do_training and (iteration < max_iterations
                                    or not keep_alive):
                    break
            except Exception:
                # a broken pipe is a client disconnect, but an error in
                # render_rgb is a real bug: log it before dropping, so that
                # a render failure does not pass for a disconnect
                log.warning("viewer client dropped: %s",
                            traceback.format_exc(limit=3).strip())
                self.drop()

    def close(self) -> None:
        self.drop()
        try:
            self.listener.close()
        except OSError:
            pass
