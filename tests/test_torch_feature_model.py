"""Port parity for models/feature_gaussians.py.

The same seeded numpy geometry and features go through the JAX package and
the port.  Neighbour maps hold the same sets row by row (ties aside, as in
test_torch_knn.py); the smoothers, given the same neighbour columns and maps,
agree to 1e-6 (float32 means over ≤ 16 unit vectors); the grid levels and the
state carried over from JAX are exact.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.models import feature_gaussians as jfgm
from seganygaussians_torch.models import feature_gaussians as tfgm
from seganygaussians_torch.models import optim as toptim

TOL = 1e-6
N, CAP, D, K = 300, 360, 32, 16


def geometry(seed=4):
    rng = np.random.default_rng(seed)
    centers = rng.uniform(-1, 1, (5, 3))
    xyz = np.concatenate([rng.normal(loc=c, scale=0.1, size=(N // 5, 3)) for c in centers])
    return dict(
        xyz=xyz.astype(np.float32),
        scaling=np.log(rng.uniform(0.02, 0.1, (N, 3))).astype(np.float32),
        rotation=rng.normal(size=(N, 4)).astype(np.float32),
        opacity=rng.normal(size=(N, 1)).astype(np.float32),
    )


@pytest.fixture(scope="module")
def states():
    g = geometry()
    js = jfgm.from_scene_geometry(g["xyz"], g["scaling"], g["rotation"], g["opacity"],
                                  capacity=CAP, smooth_k=K)
    ts = tfgm.from_scene_geometry(g["xyz"], g["scaling"], g["rotation"], g["opacity"],
                                  capacity=CAP, smooth_k=K, device="cpu")
    # the same features on both sides (the two packages' generators differ)
    feats = np.random.default_rng(9).normal(size=(CAP, D)).astype(np.float32)
    feats[7] = 0.0  # an all-zero row: the normalisation must stay finite
    js = js._replace(point_features=jnp.asarray(feats))
    ts = ts._replace(point_features=torch.from_numpy(feats),
                     smooth_map=torch.from_numpy(np.asarray(js.smooth_map).astype(np.int64)))
    return g, js, ts


def test_from_scene_geometry_matches_jax():
    g = geometry()
    js = jfgm.from_scene_geometry(g["xyz"], g["scaling"], g["rotation"], g["opacity"],
                                  capacity=CAP, smooth_k=K)
    ts = tfgm.from_scene_geometry(g["xyz"], g["scaling"], g["rotation"], g["opacity"],
                                  capacity=CAP, smooth_k=K, device="cpu", seed=3)
    for name in ("xyz", "scaling", "rotation", "opacity", "alive"):
        np.testing.assert_array_equal(getattr(ts.geom, name).numpy(),
                                      np.asarray(getattr(js.geom, name)))
    got, want = ts.smooth_map.numpy(), np.asarray(js.smooth_map)
    assert got.shape == want.shape == (CAP, K)
    rows = np.arange(CAP)
    np.testing.assert_array_equal(got[:, 0], rows)  # self at column 0
    np.testing.assert_array_equal(got[N:], np.repeat(rows[N:, None], K, 1))  # dead → self
    assert got[:N].max() < N  # live points never pick a dead slot
    xyz = g["xyz"]
    for r in np.nonzero([set(a) != set(b) for a, b in zip(got[:N], want[:N])])[0]:
        da = np.sort(((xyz[got[r]] - xyz[r]) ** 2).sum(-1))
        db = np.sort(((xyz[want[r]] - xyz[r]) ** 2).sum(-1))
        np.testing.assert_allclose(da, db, rtol=1e-6, atol=0, err_msg=f"row {r}")
    # features: seeded, small, and with their Adam state
    assert ts.point_features.shape == (CAP, D)
    assert 0.005 < float(ts.point_features.std()) < 0.02
    again = tfgm.from_scene_geometry(g["xyz"], g["scaling"], g["rotation"], g["opacity"],
                                     capacity=CAP, device="cpu", seed=3)
    assert torch.equal(again.point_features, ts.point_features)
    assert isinstance(ts.opt, toptim.AdamState) and int(ts.opt.count) == 0
    assert float(ts.opt.mu.point_features.abs().max()) == 0.0


def test_coarse_seg_target_starts_at_zero_and_rotations_stay_finite():
    g = geometry()
    ts = tfgm.from_scene_geometry(g["xyz"], g["scaling"], g["rotation"], g["opacity"],
                                  capacity=CAP, target="coarse_seg_everything", device="cpu")
    assert float(ts.point_features.abs().max()) == 0.0
    rot = tfgm.get_rotation(ts.geom)
    assert bool(torch.isfinite(rot).all())  # zero quaternions of the padded slots
    assert float(rot[N:].abs().max()) == 0.0
    js = jfgm.FrozenGeometry(*(jnp.asarray(x.numpy()) for x in ts.geom))
    for fn in ("get_rotation", "get_scaling", "get_opacity"):
        np.testing.assert_allclose(getattr(tfgm, fn)(ts.geom).numpy(),
                                   np.asarray(getattr(jfgm, fn)(js)), atol=TOL, rtol=TOL)


@pytest.mark.parametrize("dropout", [0.5, -1.0])
def test_smoothed_point_features_matches_jax(states, dropout):
    _, js, ts = states
    key = jax.random.PRNGKey(11)
    want = np.asarray(jfgm.smoothed_point_features(js, key=key, dropout=dropout))
    cols = None
    if 0.0 < dropout < 1.0:  # the columns the JAX call drew from its key
        cols = torch.from_numpy(np.asarray(jax.random.permutation(key, K)[: int(K * dropout)]))
    got = tfgm.smoothed_point_features(ts, cols).numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)


def test_dropout_columns():
    g = torch.Generator().manual_seed(2)
    cols = tfgm.dropout_columns(g, 16, 0.5)
    assert cols.shape == (8,) and len(set(cols.tolist())) == 8 and int(cols.max()) < 16
    assert tfgm.dropout_columns(g, 16, -1.0) is None and tfgm.dropout_columns(g, 16, 1.0) is None


def test_smooth_point_features_inplace_matches_jax(states):
    _, js, ts = states
    want = np.asarray(jfgm.smooth_point_features_inplace(js, 24).point_features)
    before = ts.point_features.clone()
    got = tfgm.smooth_point_features_inplace(ts, 24).point_features.numpy()
    np.testing.assert_allclose(got, want, atol=TOL, rtol=0)
    np.testing.assert_array_equal(got[:, 24:], before.numpy()[:, 24:])
    assert torch.equal(ts.point_features, before)  # the input state is untouched


@pytest.mark.parametrize("weighted", [False, True])
def test_multi_res_smoothed_features_matches_jax(states, weighted):
    _, js, ts = states
    rng = np.random.default_rng(12)
    maps = [rng.integers(0, N, (CAP, k)) for k in (4, 4, 16)]
    w = rng.uniform(size=(CAP, 3)).astype(np.float32) if weighted else None
    want = np.asarray(jfgm.multi_res_smoothed_features(
        js, tuple(jnp.asarray(m) for m in maps), None if w is None else jnp.asarray(w)))
    got = tfgm.multi_res_smoothed_features(
        ts, [torch.from_numpy(m) for m in maps], None if w is None else torch.from_numpy(w))
    np.testing.assert_allclose(got.numpy(), want, atol=2 * TOL, rtol=0)  # a sum of three means


def test_smooth_features_dispatch(states):
    _, _, ts = states
    assert tfgm.smooth_features(ts, "none") is ts.point_features
    assert tfgm.smooth_features(ts, None) is ts.point_features
    cols = torch.arange(0, 16, 2)
    assert torch.equal(tfgm.smooth_features(ts, "traditional", cols=cols),
                       tfgm.smoothed_point_features(ts, cols))
    with pytest.raises(ValueError):
        tfgm.smooth_features(ts, "multi_res")
    with pytest.raises(ValueError):
        tfgm.smooth_features(ts, "bogus")


def test_build_multi_res_maps_reaches_only_the_subsample(states):
    g, _, ts = states
    maps = tfgm.build_multi_res_maps(ts, torch.Generator().manual_seed(5))
    assert [tuple(m.shape) for m in maps] == [(CAP, 4), (CAP, 4), (CAP, 16)]
    xyz = g["xyz"]
    for m, rate in zip(maps, (0.1, 0.5, 1.0)):
        m = m.numpy()
        assert m.min() >= 0 and m.max() < N  # live rows only
        chosen = np.unique(m)
        assert 0.4 * rate * N <= len(chosen) <= min(1.6 * rate * N + 5, N)
        if rate == 1.0:  # every live point is its own nearest subsampled point
            np.testing.assert_array_equal(m[:N, 0], np.arange(N))
    # level 0 against brute force over the rows it chose from
    chosen = np.unique(maps[0].numpy())
    d = ((xyz[:, None] - xyz[None, chosen]) ** 2).sum(-1)
    exact = chosen[np.argsort(d, axis=1)[:, :4]]
    recall = np.mean([len(set(a) & set(b)) / 4 for a, b in zip(maps[0].numpy()[:N], exact)])
    assert recall >= 0.95, recall


def test_grid_levels_exact(states):
    g, js, ts = states
    xyz = np.zeros((CAP, 3), np.float32)
    xyz[:N] = g["xyz"]
    jg = jfgm.init_grid_levels(jnp.asarray(xyz))
    tg = tfgm.init_grid_levels(torch.from_numpy(xyz))
    np.testing.assert_array_equal(tg.idx_mapper.numpy(), np.asarray(jg.idx_mapper))
    assert [tuple(t.shape) for t in tg.tables] == [tuple(t.shape) for t in jg.tables]
    rng = np.random.default_rng(13)
    tables = [rng.normal(size=t.shape).astype(np.float32) for t in jg.tables]
    jg = jg._replace(tables=tuple(jnp.asarray(t) for t in tables))
    tg = tg._replace(tables=tuple(torch.from_numpy(t) for t in tables))
    want = np.asarray(jfgm.concat_point_features(js, jg))
    got = tfgm.concat_point_features(ts, tg).numpy()
    assert got.shape == (CAP, 30 + D)
    np.testing.assert_array_equal(got, want)
    assert tfgm.concat_point_features(ts, None) is ts.point_features


def test_feature_state_from_jax_round_trip(states):
    _, js, _ = states
    rng = np.random.default_rng(14)
    mu, nu = (rng.normal(size=(CAP, D)).astype(np.float32) for _ in range(2))
    js = js._replace(opt=js.opt._replace(mu=jnp.asarray(mu), nu=jnp.asarray(nu ** 2),
                                         count=jnp.asarray(7, jnp.int32)))
    fields = jax.tree_util.tree_map(np.asarray, js)
    ts = tfgm.feature_state_from_jax(fields, device="cpu")
    for name in tfgm.FrozenGeometry._fields:
        np.testing.assert_array_equal(getattr(ts.geom, name).numpy(),
                                      np.asarray(getattr(js.geom, name)))
    np.testing.assert_array_equal(ts.point_features.numpy(), np.asarray(js.point_features))
    np.testing.assert_array_equal(ts.smooth_map.numpy(), np.asarray(js.smooth_map))
    assert ts.smooth_map.dtype == torch.int64 and ts.geom.alive.dtype == torch.bool
    np.testing.assert_array_equal(ts.opt.mu.point_features.numpy(), mu)
    np.testing.assert_array_equal(ts.opt.nu.point_features.numpy(), nu ** 2)
    assert int(ts.opt.count) == 7 and ts.opt.count.dtype == torch.int32
    # an eval-mode state (no optimizer) comes across too
    assert tfgm.feature_state_from_jax(fields._replace(opt=None), device="cpu").opt is None


def test_from_point_cloud_matches_jax():
    pts = geometry()["xyz"]
    js = jfgm.from_point_cloud(pts, capacity=CAP)
    ts = tfgm.from_point_cloud(pts, capacity=CAP, device="cpu")
    np.testing.assert_allclose(ts.geom.scaling.numpy(), np.asarray(js.geom.scaling),
                               atol=1e-5, rtol=1e-5)  # log of the 3-NN distance
    np.testing.assert_array_equal(ts.geom.rotation.numpy(), np.asarray(js.geom.rotation))
    np.testing.assert_allclose(ts.geom.opacity.numpy(), np.asarray(js.geom.opacity), atol=TOL)
    assert float(ts.point_features.abs().max()) == 0.0
