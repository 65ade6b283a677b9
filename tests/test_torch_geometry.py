"""Port parity: camera, transforms, SH and preprocess against the JAX package.

The same numpy inputs (seeded) go through ``seganygaussians_tpu`` and
``seganygaussians_torch`` on the CPU.  Float outputs are held to 1e-5 relative
to their scale; integer outputs (radii, rects, tiles_touched, valid) exactly.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.ops import camera as jcam
from seganygaussians_tpu.ops import projection as jproj
from seganygaussians_tpu.ops import sh as jsh
from seganygaussians_tpu.ops import transforms as jtr
from seganygaussians_torch.ops import camera as tcam
from seganygaussians_torch.ops import projection as tproj
from seganygaussians_torch.ops import sh as tsh
from seganygaussians_torch.ops import transforms as ttr
from tests.test_rasterize import make_scene


def torch_camera(cam) -> tcam.CameraParams:
    """The port's CameraParams holding the same matrices as a JAX camera."""
    return tcam.CameraParams(
        world_view=np.asarray(cam.world_view),
        full_proj=np.asarray(cam.full_proj),
        cam_center=np.asarray(cam.cam_center),
        width=cam.width,
        height=cam.height,
        tan_fovx=cam.tan_fovx,
        tan_fovy=cam.tan_fovy,
    )


def t(a):
    return torch.from_numpy(np.array(a))


def assert_close_scaled(got, want, tol=1e-5, err_msg=""):
    want = np.asarray(want)
    scale = max(float(np.abs(want).max()), 1.0)
    np.testing.assert_allclose(np.asarray(got), want, atol=tol * scale, rtol=0, err_msg=err_msg)


def test_fov_helpers():
    for fov, px in ((0.7, 640), (1.3, 97.0)):
        assert tcam.fov2focal(fov, px) == jcam.fov2focal(fov, px)
        f = tcam.fov2focal(fov, px)
        assert tcam.focal2fov(f, px) == jcam.focal2fov(f, px)


@pytest.mark.parametrize("shift", [False, True])
def test_make_camera_matches(rng, shift):
    q = rng.normal(size=4)
    q /= np.linalg.norm(q)
    R = np.asarray(ttr.build_rotation(t(q[None].astype(np.float32)))[0], np.float64)
    tvec = rng.normal(size=3)
    kw = dict(fovx=1.1, fovy=0.8, width=200, height=150, translate=rng.normal(size=3),
              scale=1.3, cx=110.0, cy=70.0, allow_principal_point_shift=shift)
    a = jcam.make_camera(R, tvec, **kw)
    b = tcam.make_camera(R, tvec, **kw)
    for name in ("world_view", "full_proj", "cam_center"):
        np.testing.assert_array_equal(getattr(b, name), np.asarray(getattr(a, name)), err_msg=name)
    for name in ("width", "height", "tan_fovx", "tan_fovy", "focal_x", "focal_y"):
        assert getattr(b, name) == getattr(a, name), name
    np.testing.assert_array_equal(
        tcam.get_projection_matrix(0.01, 100.0, 1.1, 0.8, 200, 150, 110.0, 70.0),
        jcam.get_projection_matrix(0.01, 100.0, 1.1, 0.8, 200, 150, 110.0, 70.0),
    )


def test_transforms_match(rng):
    n = 64
    q = rng.normal(size=(n, 4)).astype(np.float32)
    s = rng.uniform(0.01, 0.5, (n, 3)).astype(np.float32)
    assert_close_scaled(ttr.build_rotation(t(q)).numpy(), jtr.build_rotation(jnp.asarray(q)))
    for mod in (1.0, 0.7):
        assert_close_scaled(
            ttr.build_covariance_3d(t(s), t(q), mod).numpy(),
            jtr.build_covariance_3d(jnp.asarray(s), jnp.asarray(q), mod),
        )
    sym = rng.normal(size=(n, 3, 3)).astype(np.float32)
    np.testing.assert_array_equal(
        ttr.strip_symmetric(t(sym)).numpy(), np.asarray(jtr.strip_symmetric(jnp.asarray(sym)))
    )
    x = rng.uniform(0.05, 0.95, n).astype(np.float32)
    assert_close_scaled(ttr.inverse_sigmoid(t(x)).numpy(), jtr.inverse_sigmoid(jnp.asarray(x)))


@pytest.mark.parametrize("deg", [0, 1, 2, 3, 4])
def test_eval_sh_matches(rng, deg):
    n = 50
    sh = rng.normal(size=(n, 3, (deg + 1) ** 2)).astype(np.float32)
    means = rng.normal(size=(n, 3)).astype(np.float32)
    center = rng.normal(size=3).astype(np.float32)
    dirs = means - center
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    assert_close_scaled(
        tsh.eval_sh(deg, t(sh), t(dirs)).numpy(),
        jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs)),
    )
    assert_close_scaled(
        tsh.eval_sh_color(deg, t(sh), t(means), t(center)).numpy(),
        jsh.eval_sh_color(deg, jnp.asarray(sh), jnp.asarray(means), jnp.asarray(center)),
    )
    rgb = rng.uniform(size=(n, 3)).astype(np.float32)
    assert_close_scaled(tsh.rgb2sh(t(rgb)).numpy(), jsh.rgb2sh(jnp.asarray(rgb)))
    assert_close_scaled(tsh.sh2rgb(t(rgb)).numpy(), jsh.sh2rgb(jnp.asarray(rgb)))


@pytest.mark.parametrize(
    "case", ["exact_rects", "sigma3_rects", "active_mask", "scale_modifier", "tile32"]
)
def test_preprocess_matches(rng, case):
    camera, means, scales, quats, opac, _ = make_scene(rng, n=200, width=96, height=64)
    # A few Gaussians behind the near plane and off-screen exercise the culls.
    means[:10, 2] = rng.uniform(-1.0, 0.15, 10)
    means[10:20, 0] += 30.0
    active = rng.uniform(size=200) > 0.2 if case == "active_mask" else None
    kw = dict(
        scale_modifier=0.8 if case == "scale_modifier" else 1.0,
        tile_size=32 if case == "tile32" else 16,
    )
    use_opa = case != "sigma3_rects"
    a = jproj.preprocess(
        jnp.asarray(means), camera, scales=jnp.asarray(scales), rotations=jnp.asarray(quats),
        active_mask=None if active is None else jnp.asarray(active),
        opacities=jnp.asarray(opac) if use_opa else None, **kw,
    )
    b = tproj.preprocess(
        t(means), torch_camera(camera), scales=t(scales), rotations=t(quats),
        active_mask=None if active is None else t(active),
        opacities=t(opac) if use_opa else None, **kw,
    )
    valid = np.asarray(a.valid)
    np.testing.assert_array_equal(b.valid.numpy(), valid)
    for name in ("radii", "rect_min", "rect_max", "tiles_touched"):
        np.testing.assert_array_equal(
            getattr(b, name).numpy(), np.asarray(getattr(a, name)), err_msg=name
        )
    for name in ("means2d", "conics", "depths"):
        assert_close_scaled(
            getattr(b, name).numpy()[valid], np.asarray(getattr(a, name))[valid], err_msg=name
        )
    assert valid.sum() > 100 and (~valid).sum() >= 20


@pytest.mark.parametrize("tile_size", [16, 8])
def test_preprocess_row_footprints_not_ported(rng, tile_size):
    """Kept under its old name: the row footprints are ported now, and
    ``preprocess(row_footprints=True)`` matches the JAX package's, the
    per-row intervals (``row_pack``) and their tile count exactly."""
    camera, means, scales, quats, opac, _ = make_scene(rng, n=200, width=96, height=64)
    # Strongly anisotropic footprints, where rows cut the most.
    scales[:, 1] *= 0.2
    means[:10, 2] = rng.uniform(-1.0, 0.15, 10)
    kw = dict(tile_size=tile_size, row_footprints=True)
    a = jproj.preprocess(jnp.asarray(means), camera, scales=jnp.asarray(scales),
                         rotations=jnp.asarray(quats), opacities=jnp.asarray(opac), **kw)
    b = tproj.preprocess(t(means), torch_camera(camera), scales=t(scales), rotations=t(quats),
                         opacities=t(opac), **kw)
    for name in ("valid", "row_pack", "tiles_touched", "rect_min", "rect_max"):
        np.testing.assert_array_equal(getattr(b, name).numpy(), np.asarray(getattr(a, name)),
                                      err_msg=name)
    rect = (b.rect_max - b.rect_min).prod(dim=1)
    assert int(b.tiles_touched.sum()) < int(rect[b.valid].sum())
    assert tproj.preprocess(t(means), torch_camera(camera), scales=t(scales),
                            rotations=t(quats), row_footprints=True).row_pack is None
