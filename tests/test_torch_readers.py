"""Port parity for the Blender (NeRF-synthetic) and LERF scene readers.

The test writes a tiny ``transforms_train.json`` / ``transforms_test.json``
scene and a tiny LERF ``transforms.json`` scene (images included), and both
packages read them on the CPU: the same ``CameraInfo`` records (rotations
and translations to 1e-12, every other field exactly), the same split, the
same NeRF++ normalisation and the same point cloud.
"""

import json
import math
import shutil

import numpy as np
import pytest
from PIL import Image

from seganygaussians_tpu.data import readers as jreaders
from seganygaussians_torch.data import readers as treaders


def c2w(eye):
    """A NeRF camera-to-world matrix at ``eye`` looking at the origin
    (OpenGL: the camera looks down its −z, y up)."""
    back = np.asarray(eye, float) / np.linalg.norm(eye)
    right = np.cross([0.0, 0.0, 1.0], back)
    right /= np.linalg.norm(right)
    up = np.cross(back, right)
    m = np.eye(4)
    m[:3, 0], m[:3, 1], m[:3, 2], m[:3, 3] = right, up, back, eye
    return m


def write_image(path, w, h, seed):
    path.parent.mkdir(parents=True, exist_ok=True)
    rng = np.random.default_rng(seed)
    Image.fromarray(rng.integers(0, 255, (h, w, 4), dtype=np.uint8)).save(path)


def blender_scene(root, with_test=True):
    """Three training views and two test views at 20×16; file paths
    without extension, as NeRF-synthetic writes them."""
    for split, count in (("train", 3), ("test", 2 if with_test else 0)):
        if not count:
            continue
        frames = []
        for i in range(count):
            ang = 2 * math.pi * i / count + (0.3 if split == "test" else 0.0)
            write_image(root / split / f"r_{i}.png", 20, 16, 10 * i + len(split))
            frames.append({"file_path": f"./{split}/r_{i}",
                           "transform_matrix": c2w([4 * math.cos(ang), 4 * math.sin(ang),
                                                    1.0 + 0.2 * i]).tolist()})
        (root / f"transforms_{split}.json").write_text(
            json.dumps({"camera_angle_x": 0.69, "frames": frames}))
    return str(root)


def lerf_scene(root):
    """Four views: shared intrinsics, one frame with its own size, focal
    lengths and principal point."""
    frames = []
    for i in range(4):
        ang = math.pi * i / 2
        frame = {"file_path": f"images/frame_{i:05d}.png",
                 "transform_matrix": c2w([3 * math.cos(ang), 3 * math.sin(ang), 0.5]).tolist()}
        w, h = 24, 18
        if i == 2:
            w, h = 30, 20
            frame.update(w=w, h=h, fl_x=25.0, fl_y=23.0, cx=14.0, cy=11.0)
        write_image(root / frame["file_path"], w, h, i)
        frames.append(frame)
    (root / "transforms.json").write_text(
        json.dumps({"w": 24, "h": 18, "fl_x": 20.0, "cx": 12.5, "frames": frames}))
    return str(root)


def assert_same_info(got, want, root=None):
    """``root``: (port's directory, JAX's directory) where the two read
    copies of one scene."""
    def same_path(x):
        return x.replace(*root) if root and isinstance(x, str) else x

    assert len(got.train_cameras) == len(want.train_cameras)
    assert len(got.test_cameras) == len(want.test_cameras)
    for a, b in zip(got.train_cameras + got.test_cameras, want.train_cameras + want.test_cameras):
        assert a._fields == b._fields
        for name in a._fields:
            x, y = getattr(a, name), getattr(b, name)
            if name in ("R", "T"):
                np.testing.assert_allclose(x, y, atol=1e-12, rtol=0)
            else:
                assert same_path(x) == y, (name, x, y)
    np.testing.assert_allclose(got.translate, want.translate, atol=1e-12, rtol=0)
    assert got.radius == pytest.approx(want.radius, abs=1e-12)
    assert same_path(got.ply_path) == want.ply_path
    for x, y in ((got.points, want.points), (got.colors, want.colors)):
        assert (x is None) == (y is None)
        if x is not None:
            np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("eval_split", [False, True])
def test_blender_reader_matches_jax(tmp_path, eval_split):
    # Each package writes the random point cloud itself (no points3d.ply yet).
    jroot = blender_scene(tmp_path / "jax")
    troot = shutil.copytree(jroot, str(tmp_path / "port"))
    want = jreaders.read_blender_scene(jroot, eval_split=eval_split)
    got = treaders.read_blender_scene(troot, eval_split=eval_split)
    assert len(got.train_cameras) == (3 if eval_split else 5)
    assert len(got.test_cameras) == (2 if eval_split else 0)
    assert got.points.shape == (100_000, 3)
    assert got.ply_path.startswith(troot)
    assert_same_info(got, want, root=(troot, jroot))
    # Through detect_and_read, with the keys Scene passes.
    kw = dict(images="images", eval_split=eval_split, need_masks=True, white_background=True)
    assert_same_info(treaders.detect_and_read(troot, **kw), got)
    cam = got.train_cameras[0]
    assert (cam.width, cam.height) == (20, 16) and cam.image_path.endswith("r_0.png")


def test_blender_reader_without_test_split(tmp_path):
    root = blender_scene(tmp_path / "scene", with_test=False)
    got = treaders.read_blender_scene(root, eval_split=True)
    want = jreaders.read_blender_scene(root, eval_split=True)
    assert len(got.train_cameras) == 3 and got.test_cameras == []
    assert_same_info(got, want)


def test_lerf_reader_matches_jax(tmp_path):
    root = lerf_scene(tmp_path / "scene")
    want = jreaders.read_lerf_scene(root)
    got = treaders.read_lerf_scene(root)
    assert got.points is None and len(got.train_cameras) == 4
    assert_same_info(got, want)
    cam = got.train_cameras[2]
    assert (cam.width, cam.height, cam.cx, cam.cy) == (30, 20, 14.0, 11.0)
    assert got.train_cameras[0].cy == 9.0
    assert_same_info(treaders.detect_and_read(root, eval_split=True, images="images"), got)
