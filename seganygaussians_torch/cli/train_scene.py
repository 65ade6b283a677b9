"""3DGS scene training CLI.

Counterpart of ``seganygaussians_tpu/cli/train_scene.py`` with the same flags
plus ``--device``:

    python -m seganygaussians_torch.cli.train_scene -s <scene> -m <out> [...]

Runs on CUDA unless ``--device cpu`` is given; asking for CUDA on a machine
without it raises.  On the card it turns TF32 off for matmuls and cuDNN (SSIM
also guards its own convolution).  Saves, test evaluations and checkpoints
fire at their exact iterations.  Unless ``--disable_viewer`` is given, the
SIBR network viewer's socket (``viewer/network_gui.py``, ``--ip``/``--port``)
is polled after every iteration, as the reference's loop does; if the port
cannot be bound the run says so and trains headless.
"""

from __future__ import annotations

import os
import sys



def main(argv=None):
    from seganygaussians_torch import checkpoint as ckpt
    from seganygaussians_torch.config import (
        PipelineConfig, TrainHyper, add_group, extract, make_parser, save_cfg,
    )
    from seganygaussians_torch.cli.render import select_device
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.scene import ModelConfig, Scene
    from seganygaussians_torch.train.scene_trainer import SceneTrainer
    from seganygaussians_torch.utils.reporting import TrainingReporter

    parser = make_parser("Scene training")
    add_group(parser, TrainHyper, "Optimization Parameters")
    parser.add_argument("--test_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--save_iterations", nargs="+", type=int, default=[7_000, 30_000])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int, default=[])
    parser.add_argument("--start_checkpoint", type=str, default=None)
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--backend", type=str, default="auto")
    parser.add_argument("--raster_capacity", type=int, default=1 << 20)
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)

    device = select_device(args.device)

    cfg = extract(ModelConfig, args)
    hyper = extract(TrainHyper, args)
    pipe = extract(PipelineConfig, args)
    if not cfg.model_path:
        cfg.model_path = os.path.join("./output", os.path.basename(cfg.source_path))
    os.makedirs(cfg.model_path, exist_ok=True)
    save_cfg(cfg.model_path, {"model": cfg, "opt": hyper, "pipe": pipe}, "cfg_args")

    scene = Scene(cfg, seed=args.seed, device=device)
    trainer = SceneTrainer(
        state=scene.gaussians,
        cameras=scene.get_train_cameras(),
        spatial_lr_scale=scene.cameras_extent,
        hyper=hyper,
        sh_degree=cfg.sh_degree,
        white_background=cfg.white_background,
        config=RasterConfig(capacity=args.raster_capacity, backend=args.backend),
        seed=args.seed,
    )

    start_iteration = 0
    if args.start_checkpoint:
        trainer.state, meta = ckpt.load_checkpoint(args.start_checkpoint, trainer.state)
        start_iteration = int(meta.get("iteration", 0))
        print(f"Resumed from {args.start_checkpoint} at iter {start_iteration}")

    save_at = set(args.save_iterations) | {hyper.iterations}
    test_at = set(args.test_iterations)
    ckpt_at = set(args.checkpoint_iterations)
    ckpt_dir = os.path.join(cfg.model_path, "checkpoints")
    reporter = TrainingReporter(cfg.model_path)

    gui = None
    if not args.disable_viewer:
        from seganygaussians_torch.viewer.network_gui import NetworkGUI

        try:
            gui = NetworkGUI(args.ip, args.port)
        except OSError as e:
            print(f"viewer socket unavailable ({e}); continuing headless")

    def poll_viewer(tr, it):
        """Serve the connected viewer's render requests; keep serving while
        it pauses training (``train`` 0), and past the last iteration while
        it asks to be kept alive.  The frame is the trainer's state at its
        current SH degree, rendered with the trainer's raster settings."""
        from seganygaussians_torch.viewer.interactive import render_view

        def dropped(e):
            print(f"viewer dropped ({e!r}); training on")
            gui.drop()

        while gui.try_connect():
            try:
                req = gui.receive()
            except (OSError, ValueError, KeyError) as e:  # the viewer left or sent garbage
                dropped(e)
                break
            img = None
            if req is not None:
                img = render_view(tr.state, req.camera, sh_degree=tr.active_sh_degree,
                                  config=tr.config)
            try:
                gui.send(img, cfg.source_path)
            except OSError as e:
                dropped(e)
                break
            if req is None or req.do_training or (it >= hyper.iterations and not req.keep_alive):
                break

    def on_iteration(tr, it, metrics):
        if gui is not None:
            poll_viewer(tr, it)
        if it in test_at and scene.get_test_cameras():
            rep = tr.eval_report(scene.get_test_cameras())
            reporter.eval_report(it, "test", rep["l1"], rep["psnr"])
            alive = tr.state.alive
            opac = gm.get_opacity(tr.state.params)[alive, 0].detach().cpu().numpy()
            reporter.histogram(it, "scene/opacity", opac)
            reporter.scalars(it, {"scene/n_alive": int(alive.sum())})
        if it in save_at:
            scene.gaussians = tr.state
            print(f"[ITER {it}] saved {scene.save(it, target='scene')}")
        if it in ckpt_at:
            path = ckpt.save_checkpoint(
                ckpt_dir, tr.state, it, extra={"active_sh_degree": tr.active_sh_degree}
            )
            print(f"[ITER {it}] checkpoint {path}")

    def on_eval(tr, it, metrics):
        print(f"[ITER {it}] loss={metrics['loss']:.5f} n_alive={int(metrics['n_alive'])} "
              f"({metrics['elapsed_s']:.1f}s)", flush=True)
        reporter.scalars(it, {"train/loss": metrics["loss"], "train/l1": metrics["l1"],
                              "train/n_alive": metrics["n_alive"]})

    trainer.on_iteration = on_iteration
    trainer.on_eval = on_eval
    try:
        trainer.run(iterations=hyper.iterations, log_every=100,
                    start_iteration=start_iteration)
    finally:
        reporter.close()
        if gui is not None:
            gui.close()
    scene.gaussians = trainer.state
    print("Training complete.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
