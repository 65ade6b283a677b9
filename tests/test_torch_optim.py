"""Port parity for models/optim.py: masked Adam, its row surgery and expon_lr.

The same seeded parameters and gradient sequence go through both packages;
parameters and moments agree to 1e-6 relative after several steps (float32
elementwise arithmetic, learning rates computed in float64 on the host in the
port and float32 in JAX).
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from seganygaussians_tpu.models import gaussians as jgm
from seganygaussians_tpu.models import optim as joptim
from seganygaussians_torch.models import gaussians as tgm
from seganygaussians_torch.models import optim as toptim


def _params(rng, cap=12):
    shapes = dict(xyz=(cap, 3), features_dc=(cap, 1, 3), features_rest=(cap, 3, 3),
                  scaling=(cap, 3), rotation=(cap, 4), opacity=(cap, 1))
    return {k: rng.normal(size=s).astype(np.float32) for k, s in shapes.items()}


def _close(tparams, jparams, rtol=1e-6, atol=1e-7):
    for name in tgm.GaussianParams._fields:
        np.testing.assert_allclose(getattr(tparams, name).numpy(),
                                   np.asarray(getattr(jparams, name)),
                                   rtol=rtol, atol=atol, err_msg=name)


def test_adam_update_matches_jax_over_steps(rng):
    p0 = _params(rng)
    jp = jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in p0.items()})
    tp = tgm.GaussianParams(**{k: torch.from_numpy(v) for k, v in p0.items()})
    jst, tst = joptim.adam_init(jp), toptim.adam_init(tp)
    hyper = jgm.TrainHyper()
    for step in range(1, 6):
        g = _params(rng)
        jp, jst = joptim.adam_update(
            jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in g.items()}), jst, jp,
            jgm.make_lr_tree(hyper, 2.5, jnp.asarray(step)))
        tp, tst = toptim.adam_update(
            tgm.GaussianParams(**{k: torch.from_numpy(v) for k, v in g.items()}), tst, tp,
            tgm.make_lr_tree(tgm.TrainHyper(), 2.5, step))
    _close(tp, jp)
    _close(tst.mu, jst.mu)
    _close(tst.nu, jst.nu)
    assert int(tst.count) == int(jst.count) == 5


@pytest.mark.parametrize("leaf", [None, "opacity", "xyz"])
def test_zero_rows_match_jax(rng, leaf):
    mu, nu = _params(rng), _params(rng)
    mask = rng.uniform(size=12) < 0.4
    jst = joptim.AdamState(
        mu=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in mu.items()}),
        nu=jgm.GaussianParams(**{k: jnp.asarray(v) for k, v in nu.items()}),
        count=jnp.asarray(3, jnp.int32))
    tst = toptim.AdamState(
        mu=tgm.GaussianParams(**{k: torch.from_numpy(v) for k, v in mu.items()}),
        nu=tgm.GaussianParams(**{k: torch.from_numpy(v) for k, v in nu.items()}),
        count=torch.tensor(3, dtype=torch.int32))
    if leaf is None:
        jst = joptim.zero_rows(jst, jnp.asarray(mask))
        tst = toptim.zero_rows(tst, torch.from_numpy(mask))
    else:
        jst = joptim.zero_leaf_rows(jst, leaf, jnp.asarray(mask))
        tst = toptim.zero_leaf_rows(tst, leaf, torch.from_numpy(mask))
    _close(tst.mu, jst.mu, rtol=0, atol=0)
    _close(tst.nu, jst.nu, rtol=0, atol=0)
    assert int(tst.count) == 3


@pytest.mark.parametrize("kw", [
    dict(lr_init=1.6e-4 * 2.5, lr_final=1.6e-6 * 2.5, lr_delay_mult=0.01, max_steps=30_000),
    dict(lr_init=1e-2, lr_final=1e-4, lr_delay_steps=100, lr_delay_mult=0.1, max_steps=500),
    dict(lr_init=0.0, lr_final=0.0),
])
def test_expon_lr_matches_jax(kw):
    for step in (-1, 0, 1, 50, 99, 250, 499, 500, 29_999, 30_000, 40_000):
        want = float(joptim.expon_lr(jnp.asarray(step), **kw))
        got = toptim.expon_lr(step, **kw)
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-12, err_msg=str(step))
