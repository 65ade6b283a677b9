"""The viewer's entry points on the CPU: ``cli/gui.py`` through its
``build_session`` seam on a tiny saved model of ``examples/synth_scene``
(as ``tests/test_torch_prompt_segment_cli.py`` makes one), the SIBR poll of
``cli/train_scene.py`` over loopback, and ``cli/render.py --segment``.

The trainer's reply to a viewer request must be the bytes of
``render_view`` on the trainer's state at that iteration, its SH degree and
raster settings; a port that cannot be bound leaves the run headless, and
``--disable_viewer`` never opens the socket.  Every socket binds port 0.
"""

import json
import os
import shutil
import socket
import threading

import numpy as np
import pytest
import torch

from seganygaussians_torch.cli import gui as gui_cli
from seganygaussians_torch.cli import render as render_cli
from seganygaussians_torch.cli import train_scene
from seganygaussians_torch.models import gaussians as gm
from seganygaussians_torch.viewer import interactive, network_gui
from tests.test_torch_prompt_segment_cli import ROOT, saved_model
from tests.test_torch_viewer import viewer_message


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small CPU ops: one intra-op thread each, so that parallel test
    workers do not oversubscribe the cores; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@pytest.fixture(scope="module")
def model(tmp_path_factory):
    """A copy of the synth scene and a tiny saved model of it."""
    tmp = tmp_path_factory.mktemp("gui")
    src = str(tmp / "scene")
    shutil.copytree(os.path.join(ROOT, "examples", "synth_scene"), src)
    model = str(tmp / "model")
    n = saved_model(src, model, np.random.default_rng(3))
    return src, model, n


def test_gui_cli_builds_the_session(model):
    src, model_dir, n = model
    session, args = gui_cli.build_session(
        ["-s", src, "-m", model_dir, "--device", "cpu", "-r", "4", "--port", "0",
         "--raster_capacity", "65536"])
    assert (args.host, args.port) == ("127.0.0.1", 0)
    assert int(session.scene_state.alive.sum()) == n
    assert session.feature_state.point_features.shape[1] == 32
    assert session.config.capacity == 65536
    # The quantile transform is fitted on the views' mask scales.
    assert session.qt is not None and session.gate.w.shape == (1, 32)
    session.orbit.width, session.orbit.height = 40, 30
    session.orbit.radius = 4.0
    rgb = session.render_rgb()
    assert rgb.shape == (30, 40, 3) and rgb.std() > 0.01
    ys, xs = np.nonzero(rgb.sum(-1) > 0.1)
    session.click(int(xs[len(xs) // 2]), int(ys[len(ys) // 2]))
    mask = session.segment3d()
    assert 0 < int(mask.sum()) <= n
    session.roll_back()
    assert int(session.scene_state.alive.sum()) == n


class Client:
    """A SIBR viewer: connects as soon as the trainer's socket is bound and
    sends one request; the reply is read on a thread."""

    def __init__(self, port, msg, reply_bytes):
        self.sock = socket.create_connection(("127.0.0.1", port), timeout=120)
        payload = json.dumps(msg).encode()
        self.sock.sendall(len(payload).to_bytes(4, "little") + payload)
        self.reply = {}
        self.thread = threading.Thread(target=self._read, args=(reply_bytes,))
        self.thread.start()

    def _read(self, n):
        img = b""
        while len(img) < n:
            chunk = self.sock.recv(n - len(img))
            if not chunk:
                break
            img += chunk
        length = int.from_bytes(self.sock.recv(4), "little")
        self.reply["img"] = img
        self.reply["verify"] = self.sock.recv(length).decode()
        self.sock.close()


def train_argv(src, out, *extra):
    return ["-s", src, "-m", out, "--device", "cpu", "-r", "4", "--iterations", "3",
            "--raster_capacity", "65536", "--test_iterations", "99", *extra]


def test_trainer_serves_the_viewer(model, tmp_path, monkeypatch):
    src, _, _ = model
    w, h = 32, 24
    clients, frames = [], []

    class Recording(network_gui.NetworkGUI):
        def __init__(self, host, port):
            assert (host, port) == ("127.0.0.1", 0)
            super().__init__(host, port)
            msg = viewer_message(w, h, train=1, keep_alive=0)
            clients.append(Client(self.listener.getsockname()[1], msg, w * h * 3))

    real = interactive.render_view

    def recorded(state, camera, sh_degree=3, config=None):
        img = real(state, camera, sh_degree=sh_degree, config=config)
        snapshot = gm.GaussianState(
            params=gm.GaussianParams(*(x.detach().clone() for x in state.params)),
            alive=state.alive.clone(), seg_mask=state.seg_mask.clone())
        frames.append((snapshot, camera, sh_degree, config, img))
        return img

    monkeypatch.setattr(network_gui, "NetworkGUI", Recording)
    monkeypatch.setattr(interactive, "render_view", recorded)
    assert train_scene.main(train_argv(src, str(tmp_path / "out"), "--port", "0")) == 0
    (client,) = clients
    client.thread.join(timeout=120)
    assert not client.thread.is_alive()
    assert len(frames) == 1  # train=1: one frame, then training goes on
    state, camera, sh_degree, config, img = frames[0]
    assert (camera.width, camera.height, sh_degree) == (w, h, 0)
    assert config.capacity == 65536
    want = real(state, camera, sh_degree=sh_degree, config=config)
    assert img.shape == (h, w, 3) and np.array_equal(img, want)
    assert client.reply["img"] == (np.clip(want, 0, 1) * 255).astype(np.uint8).tobytes()
    assert client.reply["verify"] == src
    assert os.path.exists(os.path.join(str(tmp_path / "out"), "point_cloud", "iteration_3"))


def test_trainer_runs_headless_without_a_viewer(model, tmp_path, monkeypatch, capsys):
    src, _, _ = model

    class Taken(network_gui.NetworkGUI):
        def __init__(self, host, port):
            raise OSError(98, "Address already in use")

    monkeypatch.setattr(network_gui, "NetworkGUI", Taken)
    assert train_scene.main(train_argv(src, str(tmp_path / "a"))) == 0
    assert "viewer socket unavailable" in capsys.readouterr().out

    class Refused(network_gui.NetworkGUI):
        def __init__(self, host, port):
            raise AssertionError("--disable_viewer opened the socket")

    monkeypatch.setattr(network_gui, "NetworkGUI", Refused)
    assert train_scene.main(train_argv(src, str(tmp_path / "b"), "--disable_viewer")) == 0


def test_render_cli_accepts_segment(model):
    """``--segment`` is accepted and changes nothing, as in the JAX CLI (on
    the eval split's 6 test views)."""
    from PIL import Image

    src, model_dir, _ = model
    argv = ["-s", src, "-m", model_dir, "--device", "cpu", "-r", "4", "--eval",
            "--raster_capacity", "65536", "--skip_train"]
    out = os.path.join(model_dir, "scene", "ours_1", "test", "renders")
    assert render_cli.main(argv) == 0
    plain = {name: np.asarray(Image.open(os.path.join(out, name))) for name in os.listdir(out)}
    shutil.rmtree(out)
    assert render_cli.main(argv + ["--segment"]) == 0
    assert sorted(os.listdir(out)) == sorted(plain) and len(plain) == 6
    for name, img in plain.items():
        assert np.array_equal(np.asarray(Image.open(os.path.join(out, name))), img)
