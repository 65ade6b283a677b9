"""Port parity for the viewer: ``viewer/interactive.py`` (``SagaSession``,
``render_view``, ``OrbitState``), ``viewer/network_gui.py`` and
``viewer/web_gui.py``.

One seeded scene and feature field (as ``tests/test_aux.py`` builds them:
40 Gaussians, a 64×48 orbit view, the JAX session on its XLA backend) go
through both packages on the CPU.  Frames, feature maps, prompts and score
maps agree to 1e-5 (float32 sums in another order), the PCA preview to 1e-4
up to the sign of each component; the 3D mask is equal wherever a
Gaussian's score lies more than 1e-5 from the threshold, and undo and the
saved mask exactly.  Where the JAX session draws with ``jax.random`` (the
clustering's subsample and k-means++ centers) the test repeats the JAX
draws and hands them to the port.  Every socket binds port 0.
"""

import io
import json
import socket
import threading
import urllib.request

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from seganygaussians_tpu.models import feature_gaussians as jfgm
from seganygaussians_tpu.models import gaussians as jgm
from seganygaussians_tpu.ops.quantile import fit_quantile_transform as jfit
from seganygaussians_tpu.ops.rasterize import RasterConfig as JRasterConfig
from seganygaussians_tpu.seg import queries as jq
from seganygaussians_tpu.seg.scale_gate import ScaleGateParams as JGate
from seganygaussians_tpu.viewer import interactive as jviewer
from seganygaussians_tpu.viewer import network_gui as jnet
from seganygaussians_torch.models import feature_gaussians as tfgm
from seganygaussians_torch.models import gaussians as tgm
from seganygaussians_torch.ops.quantile import fit_quantile_transform as tfit
from seganygaussians_torch.ops.rasterize import RasterConfig
from seganygaussians_torch.seg.scale_gate import ScaleGateParams as TGate
from seganygaussians_torch.viewer import interactive as tviewer
from seganygaussians_torch.viewer import network_gui as tnet
from seganygaussians_torch.viewer import web_gui as tweb
from tests.test_torch_geometry import t
from tests.test_torch_seg import _jax_init

TOL = 1e-5
W, H = 64, 48


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """Many small CPU ops: one intra-op thread each, so that parallel test
    workers do not oversubscribe the cores; restored afterwards."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def scene_arrays(feature_dim, n=40, cap=64, seed=0):
    """Seeded pre-activation arrays of a 40-Gaussian scene (SH degree 1) in
    front of the orbit camera, padded to ``cap`` rows, and its feature
    field: features by the side of the scene a point is on, plus noise, and
    a brute-force K = 4 neighbour map (self first; dead rows map to self)."""
    rng = np.random.default_rng(seed)
    xyz = rng.normal(scale=0.3, size=(n, 3))
    xyz[:, 2] += 3.0
    dirs = rng.normal(size=(3, feature_dim))
    group = (xyz[:, 0] > 0).astype(int) + (xyz[:, 1] > 0.1)
    arrays = dict(
        xyz=xyz, features_dc=rng.normal(0, 0.8, (n, 1, 3)),
        features_rest=rng.normal(0, 0.2, (n, 3, 3)),
        scaling=np.log(rng.uniform(0.05, 0.15, (n, 3))), rotation=rng.normal(size=(n, 4)),
        opacity=rng.normal(1.0, 1.0, (n, 1)),
        point_features=dirs[group] + 0.5 * rng.normal(size=(n, feature_dim)))
    arrays = {k: np.concatenate([v, np.zeros((cap - n,) + v.shape[1:])]).astype(np.float32)
              for k, v in arrays.items()}
    d2 = ((xyz[:, None] - xyz[None]) ** 2).sum(-1)
    smooth_map = np.tile(np.arange(cap)[:, None], (1, 4))
    smooth_map[:n] = np.argsort(d2, axis=1, kind="stable")[:, :4]
    alive = np.arange(cap) < n
    return arrays, smooth_map, alive


def sessions(feature_dim, seed=0):
    """The JAX session (XLA backend) and the port's on the same arrays,
    both at 64×48, with the same seeded gate and quantile transform."""
    arrays, smooth_map, alive = scene_arrays(feature_dim, seed=seed)
    names = ("xyz", "features_dc", "features_rest", "scaling", "rotation", "opacity")
    geom = {k: arrays[k] for k in ("xyz", "scaling", "rotation", "opacity")}
    rng = np.random.default_rng(seed + 1)
    scales = rng.uniform(0.5, 3.0, 100).astype(np.float32)
    gate_w = rng.normal(0, 0.5, (1, feature_dim)).astype(np.float32)
    gate_b = rng.normal(1.5, 0.5, (feature_dim,)).astype(np.float32)

    jfs = jfgm.FeatureState(
        geom=jfgm.FrozenGeometry(**{k: jnp.asarray(v) for k, v in geom.items()},
                                 alive=jnp.asarray(alive)),
        point_features=jnp.asarray(arrays["point_features"]),
        smooth_map=jnp.asarray(smooth_map.astype(np.int32)), opt=None)
    js = jviewer.SagaSession(jgm.from_dense(*(arrays[k][:40] for k in names), capacity=64),
                             jfs, JGate(jnp.asarray(gate_w), jnp.asarray(gate_b)),
                             jfit(jnp.asarray(scales)),
                             config=JRasterConfig(capacity=1 << 12, backend="xla"))
    tfs = tfgm.FeatureState(
        geom=tfgm.FrozenGeometry(**{k: t(v) for k, v in geom.items()}, alive=t(alive)),
        point_features=t(arrays["point_features"]), smooth_map=t(smooth_map), opt=None)
    ts = tviewer.SagaSession(tgm.from_dense(*(arrays[k][:40] for k in names), capacity=64,
                                            device="cpu"),
                             tfs, TGate(t(gate_w), t(gate_b)), tfit(t(scales)),
                             config=RasterConfig(capacity=1 << 12))
    for s in (js, ts):
        s.orbit.width, s.orbit.height = W, H
    return js, ts


def close(got, want, tol=TOL):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), atol=tol, rtol=0)


def assert_pca_close(got, want, tol=1e-4):
    """Each channel equal, or equal to 1 − the other's (a component's sign
    flipped before the channel was scaled to [0, 1])."""
    got, want = np.asarray(got), np.asarray(want)
    for c in range(want.shape[-1]):
        same = np.abs(got[..., c] - want[..., c]).max()
        flipped = np.abs(got[..., c] - (1.0 - want[..., c])).max()
        assert min(same, flipped) <= tol, (c, same, flipped)


@pytest.mark.parametrize("feature_dim", [16, 8])
def test_session_matches_jax(feature_dim, tmp_path):
    js, ts = sessions(feature_dim)
    np.testing.assert_allclose(ts.orbit.center, js.orbit.center, atol=1e-7, rtol=0)
    rgb = ts.render_rgb()
    assert rgb.shape == (H, W, 3) and rgb.dtype == np.float32
    close(rgb, js.render_rgb())
    assert rgb.std() > 0.01
    fmap = ts.render_feature_map()
    assert tuple(fmap.shape) == (H, W, feature_dim)
    close(fmap.numpy(), js.render_feature_map())
    # Before any click the score map is zeros.
    close(ts.render_similarity(), js.render_similarity(), tol=0)

    # PCA over the frame's pixels (fewer than 10,000: JAX takes them all).
    assert_pca_close(ts.render_pca(indices=torch.arange(W * H)), js.render_pca())

    # A click on a covered pixel, then a second view's similarity map.
    ts.click(32, 24)
    js.click(32, 24)
    close(ts.chosen_features[0].numpy(), js.chosen_features[0])
    for s in (ts, js):
        s.orbit.rotate(0.3, 0.1)
    close(ts.render_similarity(), js.render_similarity())

    # segment3d with the threshold in the widest gap between the middle half
    # of the live Gaussians' scores: the mask is neither empty nor
    # everything, and no score lies near the threshold.
    feats = jfgm.smoothed_point_features(js.feature_state, key=None, dropout=-1.0)
    gated = jq.gate_features(feats, js.gate, jnp.asarray(js.scale))
    score = np.asarray(jq.similarity_to_prompts(gated, jnp.stack(js.chosen_features)))
    alive = np.asarray(js.scene_state.alive)
    live = np.sort(score[alive])
    mid = slice(len(live) // 4, 3 * len(live) // 4)
    i = int(np.argmax(np.diff(live[mid]))) + mid.start
    thr = float(0.5 * (live[i] + live[i + 1]))
    ts.threshold = js.threshold = thr
    before = ts.scene_state.alive.clone()
    got = ts.segment3d().numpy()
    want = np.asarray(js.segment3d())
    far = np.abs(score - thr) > TOL
    np.testing.assert_array_equal(got[far], want[far])
    assert 0 < got.sum() < alive.sum()
    np.testing.assert_array_equal(ts.scene_state.alive.numpy(), np.asarray(js.scene_state.alive))
    np.testing.assert_array_equal(ts.feature_state.geom.alive.numpy(),
                                  np.asarray(js.feature_state.geom.alive))
    path = ts.save_mask("m0", str(tmp_path))
    saved = torch.load(path, weights_only=False)
    assert saved.dtype == torch.bool and saved.shape == (64,)
    assert torch.equal(saved, ts.scene_state.alive)
    assert torch.equal(saved, torch.load(js.save_mask("m0_jax", str(tmp_path)),
                                         weights_only=False))
    ts.roll_back()
    js.roll_back()
    assert torch.equal(ts.scene_state.alive, before)
    np.testing.assert_array_equal(ts.scene_state.alive.numpy(), np.asarray(js.scene_state.alive))
    ts.roll_back()  # nothing left to undo
    assert torch.equal(ts.scene_state.alive, before)

    # cluster_in_3d with the JAX session's own draws: its key was split once
    # by render_pca, then once here, then into the subsample's and the
    # k-means++ keys.
    key_before = js.key
    js.cluster_in_3d(k=4)
    _, sub = jax.random.split(key_before)
    k1, k2 = jax.random.split(sub)
    live = np.flatnonzero(alive)
    gated_live = np.asarray(gated)[live]
    m = max(4, int(len(live) * 0.02))
    idx = np.asarray(jax.random.choice(k1, len(live), (m,), replace=False))
    ts.cluster_in_3d(k=4, indices=t(idx), init_centers=t(_jax_init(k2, gated_live[idx], 4, True)))
    close(ts.cluster_centers.numpy(), js.cluster_centers)
    palette = np.asarray(jax.random.uniform(jax.random.PRNGKey(7), (4, 3), minval=0.2))
    got_cl = ts.render_cluster(palette=palette)
    want_cl = js.render_cluster()
    assert got_cl.shape == (H, W, 3)
    # Labels are argmaxes of cosines: equal wherever the best two centers
    # are more than 1e-5 apart, and on the background (a zero feature: every
    # cosine 0, the first center in both).
    fmap = np.array(js.render_feature_map())
    norm = np.linalg.norm(fmap, axis=-1, keepdims=True)
    sims = np.sort((fmap / np.clip(norm, 1e-9, None)) @ np.asarray(js.cluster_centers).T, axis=-1)
    clear = ((sims[..., -1] - sims[..., -2]) > TOL) | (norm[..., 0] == 0)
    np.testing.assert_array_equal(got_cl[clear], want_cl[clear])
    assert clear.mean() > 0.9
    # The port's own palette: seeded, in [0.2, 1).
    own = tviewer.cluster_palette(4)
    assert np.array_equal(own, tviewer.cluster_palette(4)) and own.min() >= 0.2 and own.max() < 1


def test_session_refuses_segment_without_a_click():
    _, ts = sessions(8)
    with pytest.raises(ValueError, match="at least one click"):
        ts.segment3d()
    ts.clear_clicks()
    assert ts.chosen_features == []


def test_orbit_and_render_view_match_jax():
    js, ts = sessions(8)
    jo, to = js.orbit, ts.orbit
    for args in ((0.4, 1.2), (0.1, 0.9), (-0.2, -4.0)):
        jo.rotate(*args)
        to.rotate(*args)
    assert to.elevation == jo.elevation == -1.5  # clamped
    for f in (0.5, 1e-3, 1e5):
        jo.zoom(f)
        to.zoom(f)
        assert to.radius == jo.radius
    assert to.radius == 100.0
    jo.zoom(0.02)
    to.zoom(0.02)
    jo.pan(0.3, -0.2)
    to.pan(0.3, -0.2)
    np.testing.assert_allclose(to.center, jo.center, atol=1e-6, rtol=0)
    jc, tc = jo.params(), to.params()
    for name in ("world_view", "full_proj", "cam_center"):
        close(getattr(tc, name), getattr(jc, name), tol=1e-6)
    assert (tc.width, tc.height) == (jc.width, jc.height) == (W, H)
    # render_view at SH degree 0 and 1 on an orbit camera facing the points.
    jo.radius = to.radius = 2.5
    jo.elevation = to.elevation = 0.2
    for deg in (0, 1):
        got = tviewer.render_view(ts.scene_state, to.params(), sh_degree=deg,
                                  config=RasterConfig(capacity=1 << 12))
        want = jviewer.render_view(js.scene_state, jo.params(), sh_degree=deg,
                                   config=JRasterConfig(capacity=1 << 12, backend="xla"))
        assert got.shape == (H, W, 3) and got.std() > 0.01
        close(got, want)


def viewer_message(w=8, h=6, train=1, keep_alive=1):
    view = np.eye(4)
    view[3, :3] = (0.1, -0.2, 3.0)
    proj = np.diag([1.2, 1.5, 1.0, 1.0])
    proj[2, 3] = 1.0
    return {
        "resolution_x": w, "resolution_y": h, "train": train,
        "fov_y": 0.8, "fov_x": 1.0, "z_near": 0.01, "z_far": 100.0,
        "shs_python": 0, "rot_scale_python": 0, "keep_alive": keep_alive,
        "scaling_modifier": 1.0,
        "view_matrix": list((view @ np.diag([1.0, -1.0, -1.0, 1.0])).flatten()),
        "view_projection_matrix": list(proj.flatten()),
    }


def test_viewer_request_matches_jax():
    msg = viewer_message()
    got, want = tnet.ViewerRequest(msg), jnet.ViewerRequest(msg)
    for name in ("width", "height", "do_training", "keep_alive", "fovx", "fovy", "znear",
                 "zfar", "scaling_modifier"):
        assert getattr(got, name) == getattr(want, name), name
    for name in ("world_view", "full_proj", "cam_center"):
        np.testing.assert_array_equal(getattr(got.camera, name), getattr(want.camera, name))
    assert got.camera.tan_fovx == want.camera.tan_fovx
    assert got.camera.tan_fovy == want.camera.tan_fovy
    wv = np.array(msg["view_matrix"], np.float32).reshape(4, 4)
    wv[:, 1:3] *= -1  # the OpenGL flips
    np.testing.assert_array_equal(got.camera.world_view, wv)
    assert tnet.ViewerRequest(dict(msg, resolution_x=0)).empty


def send_request(port, msg, reply_bytes):
    """A SIBR client: one request, then the frame and the verify string."""
    with socket.create_connection(("127.0.0.1", port), timeout=60) as s:
        payload = json.dumps(msg).encode()
        s.sendall(len(payload).to_bytes(4, "little") + payload)
        img = b""
        while len(img) < reply_bytes:
            chunk = s.recv(reply_bytes - len(img))
            assert chunk, "server closed early"
            img += chunk
        n = int.from_bytes(s.recv(4), "little")
        return img, s.recv(n).decode()


def test_network_gui_round_trip():
    gui = tnet.NetworkGUI(port=0)
    port = gui.listener.getsockname()[1]
    result = {}
    msg = viewer_message()
    client = threading.Thread(target=lambda: result.update(
        zip(("img", "verify"), send_request(port, msg, 8 * 6 * 3))))
    client.start()
    try:
        for _ in range(2000):
            if gui.try_connect():
                break
            client.join(timeout=0.005)
        req = gui.receive()
        assert req is not None and req.width == 8 and req.do_training
        frame = np.linspace(0, 1, 6 * 8 * 3, dtype=np.float32).reshape(6, 8, 3)
        gui.send(frame, "source/path")
        client.join(timeout=30)
        assert not client.is_alive()
    finally:
        gui.close()
    assert result["verify"] == "source/path"
    assert result["img"] == (frame * 255).astype(np.uint8).tobytes()


class _Orbit:
    azimuth = 0.0
    elevation = 0.0
    radius = 4.0


class StubSession:
    """The session surface the web GUI drives, recording its calls."""

    def __init__(self):
        self.orbit = _Orbit()
        self.scale = 0.5
        self.threshold = 0.75
        self.chosen_features = []
        self.calls = []

    def render_rgb(self):
        return np.full((6, 8, 3), 0.5, np.float32)

    render_pca = render_cluster = render_rgb

    def render_similarity(self):
        return np.linspace(0, 1, 48, dtype=np.float32).reshape(6, 8)

    def click(self, x, y):
        self.chosen_features.append((x, y))

    def segment3d(self):
        self.calls.append("segment")
        return np.ones(7, bool)

    def roll_back(self):
        self.calls.append("undo")

    def clear_clicks(self):
        self.chosen_features = []

    def save_mask(self):
        return "segmentation_res/final_mask.pt"

    def cluster_in_3d(self):
        self.calls.append("cluster")


def post(base, path, body=None):
    req = urllib.request.Request(base + path, data=json.dumps(body or {}).encode(),
                                 method="POST")
    with urllib.request.urlopen(req, timeout=60) as r:
        return json.loads(r.read())


def get_png(url):
    with urllib.request.urlopen(url, timeout=60) as r:
        assert r.headers["Content-Type"] == "image/png"
        return np.asarray(Image.open(io.BytesIO(r.read())))


def test_web_gui_endpoints():
    sess = StubSession()
    gui = tweb.WebGUI(sess, port=0)
    host, port = gui.start_background()
    base = f"http://{host}:{port}"
    try:
        with urllib.request.urlopen(base + "/", timeout=60) as r:
            page = r.read().decode()
        assert "segment 3D" in page and "<canvas" in page
        for mode in ("rgb", "pca", "cluster"):
            img = get_png(f"{base}/render?mode={mode}&az=0.3&el=0.1&r=3")
            assert img.shape == (6, 8, 3) and (img == 127).all()
        sim = get_png(f"{base}/render?mode=similarity")
        np.testing.assert_array_equal(
            sim, (tweb._colorize(sess.render_similarity()) * 255).astype(np.uint8))
        assert (sess.orbit.azimuth, sess.orbit.elevation, sess.orbit.radius) == (0.0, 0.0, 4.0)
        get_png(f"{base}/render?mode=rgb&az=0.3&el=0.1&r=3")
        assert (sess.orbit.azimuth, sess.orbit.elevation, sess.orbit.radius) == (0.3, 0.1, 3.0)
        assert post(base, "/click", {"x": 3, "y": 2, "az": 0.5})["status"] == "1 prompts"
        assert sess.chosen_features == [(3, 2)] and sess.orbit.azimuth == 0.5
        assert post(base, "/state", {"scale": 0.2, "threshold": 0.9})["status"] == "state updated"
        with urllib.request.urlopen(base + "/state", timeout=60) as r:
            assert json.loads(r.read()) == {"scale": 0.2, "threshold": 0.9, "prompts": 1}
        assert post(base, "/segment")["status"] == "segmented 7 gaussians"
        assert post(base, "/undo")["status"] == "rolled back"
        assert post(base, "/cluster")["status"] == "clustered"
        assert post(base, "/save")["status"] == "saved segmentation_res/final_mask.pt"
        assert post(base, "/clear")["status"] == "prompts cleared"
        assert sess.chosen_features == []
        assert sess.calls == ["segment", "undo", "cluster"]
        with pytest.raises(urllib.error.HTTPError) as e:
            post(base, "/nowhere")
        assert e.value.code == 404
        with pytest.raises(urllib.error.HTTPError) as e:
            post(base, "/click", {"y": 1})  # no x: the session's error, reported
        assert e.value.code == 500 and "error" in json.loads(e.value.read())["status"]
    finally:
        gui.shutdown()


def test_web_gui_renders_a_real_session():
    """GET /render on a CPU session: the PNG is render_rgb × 255 to within
    one level."""
    _, ts = sessions(8)
    gui = tweb.WebGUI(ts, port=0)
    host, port = gui.start_background()
    try:
        png = get_png(f"http://{host}:{port}/render?mode=rgb&az=0.2&el=0.1&r=2.5")
    finally:
        gui.shutdown()
    want = ts.render_rgb() * 255.0
    assert png.shape == (H, W, 3) and png.std() > 1
    assert np.abs(png.astype(np.float64) - want).max() <= 1.0
