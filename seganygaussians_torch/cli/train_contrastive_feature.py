"""SAGA contrastive-feature training CLI.

Counterpart of ``seganygaussians_tpu/cli/train_contrastive_feature.py``:

    python -m seganygaussians_torch.cli.train_contrastive_feature \
        -s <data> -m <model dir> [--iterations N ...]

Loads the trained scene's geometry from ``<model dir>``, trains the 32-dim
affinity features and the scale gate against the SAM masks and mask scales of
``<data>``, and writes ``contrastive_feature_point_cloud.ply`` and
``scale_gate.pt`` under ``point_cloud/iteration_N/``.  Runs on CUDA unless
``--device cpu`` is given; asking for CUDA on a machine without it raises.
"""

from __future__ import annotations

import os
import sys

import torch


def main(argv=None):
    from seganygaussians_torch.cli.render import select_device
    from seganygaussians_torch.config import (
        extract,
        load_cfg,
        make_contrastive_parser,
        save_cfg,
    )
    from seganygaussians_torch.ops.rasterize import BACKENDS, RasterConfig
    from seganygaussians_torch.scene import ModelConfig, Scene
    from seganygaussians_torch.seg.scale_gate import init_scale_gate, save_scale_gate
    from seganygaussians_torch.train.contrastive_trainer import (
        ContrastiveHyper,
        ContrastiveTrainer,
    )
    from seganygaussians_torch.utils.reporting import TrainingReporter
    from seganygaussians_torch.utils.tracing import ProfileWindow

    parser = make_contrastive_parser("Contrastive feature training")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backend", type=str, default="auto", choices=BACKENDS)
    parser.add_argument("--raster_capacity", type=int, default=1 << 20)
    parser.add_argument("--target", type=str, default="contrastive_feature")
    parser.add_argument("--device", type=str, default="cuda")
    parser.add_argument("--trace_out", type=str, default=None,
                        help="profile iterations 21-30 of the run into this directory")
    args = parser.parse_args(argv)
    device = select_device(args.device)

    cfg = extract(ModelConfig, args)
    hyper = extract(ContrastiveHyper, args)
    # the source path of the scene-training run, if none is given
    saved = load_cfg(cfg.model_path, "cfg_args")
    if saved and not cfg.source_path and "model" in saved:
        cfg.source_path = saved["model"].get("source_path", cfg.source_path)
    cfg.need_masks = True

    sample_rate = 0.2 if "Replica" in cfg.source_path else 1.0
    scene = Scene(
        cfg,
        need_scene=False,
        need_features_model=True,
        load_iteration=-1,
        target=args.target,
        mode="train",
        sample_rate=sample_rate,
        seed=args.seed,
        device=device,
    )
    save_cfg(cfg.model_path, {"model": cfg, "opt": hyper}, "feature_cfg_args")

    gate = init_scale_gate(torch.Generator().manual_seed(args.seed), cfg.feature_dim,
                           device=device)
    trainer = ContrastiveTrainer(
        feat_state=scene.feature_gaussians,
        gate_params=gate,
        cameras=scene.get_train_cameras(),
        hyper=hyper,
        config=RasterConfig(capacity=args.raster_capacity, backend=args.backend),
        seed=args.seed,
    )
    window = ProfileWindow(args.trace_out) if args.trace_out else None
    if window is not None:
        trainer.on_iteration = lambda _tr, it, _aux: window.after(it)
    try:
        trainer.run(log_every=100)
    finally:
        if window is not None:
            window.close()
    # RFN / pos-cos / neg-cos trajectories → metrics.jsonl + TensorBoard
    reporter = TrainingReporter(cfg.model_path)
    for m in trainer.metrics_history:
        reporter.scalars(
            m["iter"],
            {"contrastive/loss": m["loss"], "contrastive/rfn": m["rfn"],
             "contrastive/cos_pos": m["cosine_pos"],
             "contrastive/cos_neg": m["cosine_neg"]},
        )
    reporter.close()
    for m in trainer.metrics_history[-3:]:
        print(
            f"[ITER {m['iter']}] loss={m['loss']:.4f} RFN={m['rfn']:.3f} "
            f"cos+={m['cosine_pos']:.3f} cos-={m['cosine_neg']:.3f}"
        )

    scene.feature_gaussians = trainer.feat_state
    path = scene.save_feature(
        hyper.iterations, target=args.target, smooth_type=hyper.smooth_type,
        multi_res_maps=trainer.consts.multi_res_maps or None, seed=args.seed,
    )
    gate_path = os.path.join(os.path.dirname(path), "scale_gate.pt")
    save_scale_gate(gate_path, trainer.gate_params)
    print(f"Saved {path} and {gate_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
