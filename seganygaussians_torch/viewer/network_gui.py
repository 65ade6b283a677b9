"""SIBR remote-viewer TCP protocol (the reference's
``gaussian_renderer/network_gui.py``).

Counterpart of ``seganygaussians_tpu/viewer/network_gui.py``, standard
library sockets and numpy only.  Wire format: a 4-byte little-endian length
and a JSON request (camera, flags); the reply is the raw RGB bytes of the
frame, then a 4-byte little-endian length and the verify string (the
source path).  The viewer's OpenGL conventions are flipped (view-matrix
columns 1 and 2, projection column 1) before the ``CameraParams`` is built.
A class, no module state; the trainer polls it without blocking.
"""

from __future__ import annotations

import json
import math
import socket
from typing import Optional

import numpy as np

from seganygaussians_torch.ops.camera import CameraParams


class ViewerRequest:
    """One decoded request; ``empty`` for a 0 × 0 resolution."""

    def __init__(self, msg: dict):
        self.width = msg["resolution_x"]
        self.height = msg["resolution_y"]
        self.empty = self.width == 0 or self.height == 0
        if self.empty:
            return
        self.do_training = bool(msg["train"])
        self.keep_alive = bool(msg["keep_alive"])
        self.scaling_modifier = msg["scaling_modifier"]
        self.fovy = msg["fov_y"]
        self.fovx = msg["fov_x"]
        self.znear = msg["z_near"]
        self.zfar = msg["z_far"]
        wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
        wv[:, 1] *= -1
        wv[:, 2] *= -1
        fp = np.array(msg["view_projection_matrix"], np.float32).reshape(4, 4)
        fp[:, 1] *= -1
        self.camera = CameraParams(
            world_view=wv,
            full_proj=fp,
            cam_center=np.linalg.inv(wv)[3, :3],
            width=self.width,
            height=self.height,
            tan_fovx=math.tan(self.fovx / 2.0),
            tan_fovy=math.tan(self.fovy / 2.0),
        )


class NetworkGUI:
    """A listening socket and at most one connected viewer."""

    def __init__(self, host: str = "127.0.0.1", port: int = 6009):
        self.listener = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        try:
            self.listener.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
            self.listener.bind((host, port))
            self.listener.listen()
            self.listener.settimeout(0)
        except OSError:
            self.listener.close()
            raise
        self.conn: Optional[socket.socket] = None

    def try_connect(self) -> bool:
        """True once a viewer is connected; never blocks."""
        if self.conn is not None:
            return True
        try:
            self.conn, _ = self.listener.accept()
            self.conn.settimeout(None)
            return True
        except (BlockingIOError, socket.timeout, OSError):
            return False

    def _read_exact(self, n: int) -> bytes:
        buf = b""
        while len(buf) < n:
            chunk = self.conn.recv(n - len(buf))
            if not chunk:
                raise ConnectionError("viewer disconnected")
            buf += chunk
        return buf

    def receive(self) -> Optional[ViewerRequest]:
        """Blocking read of one request; None for a 0 × 0 resolution."""
        length = int.from_bytes(self._read_exact(4), "little")
        req = ViewerRequest(json.loads(self._read_exact(length).decode("utf-8")))
        return None if req.empty else req

    def send(self, image: Optional[np.ndarray], verify: str) -> None:
        """``image``: (H, W, 3) floats in [0, 1], or None; ``verify``: the
        string the viewer checks (the source path)."""
        if image is not None:
            raw = (np.ascontiguousarray(np.clip(image, 0, 1)) * 255).astype(np.uint8).tobytes()
            self.conn.sendall(raw)
        self.conn.sendall(len(verify).to_bytes(4, "little"))
        self.conn.sendall(verify.encode("ascii"))

    def drop(self) -> None:
        if self.conn is not None:
            try:
                self.conn.close()
            finally:
                self.conn = None

    def close(self) -> None:
        self.drop()
        self.listener.close()
