"""Interactive segmentation GUI CLI (the reference's ``saga_gui.py`` entry).

Counterpart of ``seganygaussians_tpu/cli/gui.py``: loads the trained scene,
its affinity-feature field and scale gate, and serves the browser viewer
(``viewer/web_gui.py``) over a headless ``SagaSession``.

    python -m seganygaussians_torch.cli.gui -m <model dir> [--port 8060]

Runs on CUDA unless ``--device cpu`` is given; asking for CUDA on a machine
without it raises.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch


def build_session(argv=None):
    """Parse ``argv`` and load the session it names; returns (session, args).
    ``main`` serves it."""
    from seganygaussians_torch.cli.render import select_device
    from seganygaussians_torch.config import extract, load_cfg, make_parser
    from seganygaussians_torch.ops.quantile import fit_quantile_transform
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.scene import ModelConfig, Scene
    from seganygaussians_torch.seg.scale_gate import load_scale_gate
    from seganygaussians_torch.viewer.interactive import SagaSession

    parser = make_parser("Interactive segmentation GUI")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--host", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=8060)
    parser.add_argument("--backend", type=str, default="auto")
    parser.add_argument("--raster_capacity", type=int, default=1 << 20)
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = select_device(args.device)
    cfg = extract(ModelConfig, args)
    saved = load_cfg(cfg.model_path, "cfg_args")
    if saved and not cfg.source_path and "model" in saved:
        cfg.source_path = saved["model"].get("source_path", "")
    cfg.need_masks = True

    scene = Scene(
        cfg, need_scene=True, need_features_model=True, load_iteration=-1,
        feature_load_iteration=args.iteration, target="contrastive_feature", mode="eval",
        shuffle=False, device=device,
    )
    gate = load_scale_gate(os.path.join(cfg.model_path, "point_cloud",
                                        f"iteration_{scene.feature_loaded_iter}",
                                        "scale_gate.pt"), device=device)
    all_scales = [np.asarray(c.mask_scales, np.float32).reshape(-1)
                  for c in scene.get_train_cameras() if c.mask_scales is not None]
    scales = np.concatenate(all_scales) if all_scales else np.array([0.1, 1.0, 10.0], np.float32)
    session = SagaSession(
        scene_state=scene.gaussians,
        feature_state=scene.feature_gaussians,
        gate_params=gate,
        scale_qt=fit_quantile_transform(torch.as_tensor(scales, device=device)),
        config=RasterConfig(capacity=args.raster_capacity, backend=args.backend),
    )
    return session, args


def main(argv=None):
    from seganygaussians_torch.viewer.web_gui import WebGUI

    session, args = build_session(argv)
    WebGUI(session, host=args.host, port=args.port).serve_forever()
    return 0


if __name__ == "__main__":
    sys.exit(main())
