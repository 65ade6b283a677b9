"""A run with the timed path broken underneath must come out not correct.

Each test drives the rest of a run (harness.main) on the CPU at a tiny size,
with the look for a card skipped, once sound and once for each fault the
cell can have: a step that returns its state unchanged and half of the
batch left out (training cells); an answer altered where it is produced,
a ``roll_back`` that restores nothing and a click's prompt altered (serving
cells); a neighbour map with wrong neighbours (both feature cells).  Every
cell runs on one chip, so there is no exchange between chips to leave out.  The control (the reference in TF32) is held
apart from the reference in ``test_perfbench_reference.py`` at this size
and on the card at the cells' size by ``perfbench/calibrate.py``.
"""

from __future__ import annotations

import numpy as np
import pytest
import torch

from perfbench.tests.test_perfbench_imports import _tiny_copy, run_cell


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    return _tiny_copy(tmp_path_factory.mktemp("faults"))


# Long enough for the window to hold two segment cycles (27 requests each).
SECONDS = {"m360_garden.segment": 8.0}


def _run(root, workload):
    rc, result = run_cell(root, workload, seed=123456789012, seconds=SECONDS.get(workload, 1.0))
    assert rc == 0
    return result


def _correct(root, workload):
    return _run(root, workload)["correct"]


def _failed(result) -> set:
    return {n for n, c in result["checks"].items() if not c["value"] <= c["limit"]}


def test_scene_train(root, monkeypatch):
    from seganygaussians_torch.ops import losses
    from seganygaussians_torch.train import scene_trainer as st

    assert _correct(root, "m360_garden.scene_train")
    real = st.train_step

    def unchanged(state, *args, **kw):
        return state, real(state, *args, **kw)[1]

    with monkeypatch.context() as m:
        m.setattr(st, "train_step", unchanged)
        assert not _correct(root, "m360_garden.scene_train")
    l1, ssim = losses.l1_loss, losses.ssim
    with monkeypatch.context() as m:  # half the image's rows, the mean over the rest
        m.setattr(losses, "l1_loss", lambda p, g: l1(p[: p.shape[0] // 2], g[: g.shape[0] // 2]))
        m.setattr(losses, "ssim", lambda p, g: ssim(p[: p.shape[0] // 2], g[: g.shape[0] // 2]))
        assert not _correct(root, "m360_garden.scene_train")


def test_feature_train(root, monkeypatch):
    from seganygaussians_torch.train import contrastive_trainer as ct

    assert _correct(root, "m360_garden.feature_train")
    real = ct.contrastive_step

    def unchanged(feat_state, gate_params, gate_opt, *args, **kw):
        return (feat_state, gate_params, gate_opt) + tuple(
            real(feat_state, gate_params, gate_opt, *args, **kw)[3:])

    with monkeypatch.context() as m:
        m.setattr(ct, "contrastive_step", unchanged)
        assert not _correct(root, "m360_garden.feature_train")
    draw = ct.draw_step

    def half_rays(*args, **kw):
        d = draw(*args, **kw)
        r = d.ray_idx.shape[0] // 2
        return d._replace(ray_idx=d.ray_idx[:r], pair_rand=d.pair_rand[:r, :r])

    with monkeypatch.context() as m:
        m.setattr(ct, "draw_step", half_rays)
        assert not _correct(root, "m360_garden.feature_train")


def test_segment(root, monkeypatch):
    from seganygaussians_torch.viewer.interactive import SagaSession

    assert _correct(root, "m360_garden.segment")
    real_sim, real_seg = SagaSession.render_similarity, SagaSession.segment3d

    def altered_sim(self, *args, **kw):
        s = real_sim(self, *args, **kw)
        return s + np.where(np.arange(s.size).reshape(s.shape) % 3 == 0, 0.01, 0.0)

    with monkeypatch.context() as m:
        m.setattr(SagaSession, "render_similarity", altered_sim)
        assert not _correct(root, "m360_garden.segment")

    def altered_seg(self, *args, **kw):
        mask = real_seg(self, *args, **kw)
        mask[::7] = ~mask[::7]
        return mask

    with monkeypatch.context() as m:
        m.setattr(SagaSession, "segment3d", altered_seg)
        assert not _correct(root, "m360_garden.segment")

    with monkeypatch.context() as m:  # segment3d's cut is never undone
        m.setattr(SagaSession, "roll_back", lambda self: None)
        assert not _correct(root, "m360_garden.segment")


def test_segment_altered_prompt(root, monkeypatch):
    """A click's prompt altered where it is produced: ``mask_off`` holds the
    mask to the reference's scores over its own renders of the clicks, the
    last click before a ``segment3d`` too, which no similarity frame shows."""
    from seganygaussians_torch.viewer.interactive import SagaSession

    real = SagaSession.click

    def altered_click(self, *args, **kw):  # the prompt's channels shifted by one
        real(self, *args, **kw)
        self.chosen_features[-1] = torch.roll(self.chosen_features[-1], 1)

    with monkeypatch.context() as m:
        m.setattr(SagaSession, "click", altered_click)
        result = _run(root, "m360_garden.segment")
    assert not result["correct"] and "mask_off" in _failed(result)


@pytest.mark.parametrize("workload", ["m360_garden.segment", "m360_garden.feature_train"])
def test_wrong_neighbours(root, monkeypatch, workload):
    """A neighbour map with one column of every row taken from the next
    row's list."""
    from seganygaussians_torch.models import feature_gaussians as fgm

    real = fgm.knn_map

    def altered(xyz, k, *args, **kw):
        nbrs = real(xyz, k, *args, **kw)
        nbrs[:, k // 2] = torch.roll(nbrs[:, k // 2], 1)
        return nbrs

    with monkeypatch.context() as m:
        m.setattr(fgm, "knn_map", altered)
        result = _run(root, workload)
        assert not result["correct"] and "knn_miss" in _failed(result)
