"""Scripted prompt segmentation.

Counterpart of ``seganygaussians_tpu/cli/prompt_segment.py``.

    python -m seganygaussians_torch.cli.prompt_segment -m <model dir> --point X Y
    python -m seganygaussians_torch.cli.prompt_segment -m <model dir> --text "a chair"
    python -m seganygaussians_torch.cli.prompt_segment -m <model dir> --text "a chair" --simple_lift

Point prompt: load the trained scene, its contrastive feature field and scale
gate; render the scale-gated feature map of a training view (C = 32); take
the prompt pixel's feature; threshold the per-Gaussian similarity
(``seg/queries.py``).  Text prompt: the language flow of ``seg/language.py``
(per-view mask-pooled features and anchor identifiers, mask-IoU clustering,
template-averaged CLIP scoring, similarity > 0.85), or with ``--simple_lift`` the
direct lifting of per-mask CLIP scores through the mask render's gradient
(``seg/clip_text.py:lift_scores_to_3d``).  Both need the scene's SAM masks,
mask scales and ``clip_features`` sidecars, and CLIP weights for the prompt.
Writes ``<out>/final_mask.pt`` and the segmented PLY
(``point_cloud/iteration_N/seg_point_cloud.ply``).

Runs on CUDA unless ``--device cpu`` is given.
"""

from __future__ import annotations

import os
import sys

import numpy as np
import torch

from seganygaussians_torch import render as R
from seganygaussians_torch.models import feature_gaussians as fgm
from seganygaussians_torch.ops.quantile import fit_quantile_transform
from seganygaussians_torch.seg import clip_text, language, queries


def render_feature_map(fs: fgm.FeatureState, features: torch.Tensor, camera, config) -> torch.Tensor:
    """(H, W, C) render of per-Gaussian ``features`` over the feature field's
    geometry, zero background."""
    pkg = R.render_features(
        camera, fs.geom.xyz, fgm.get_opacity(fs.geom)[:, 0], fgm.get_scaling(fs.geom),
        fgm.get_rotation(fs.geom), features, alive=fs.geom.alive, config=config,
    )
    if pkg["overflow"]:
        raise RuntimeError(f"instance capacity {config.capacity} exceeded on a feature render; "
                           "raise --raster_capacity")
    return pkg["render"]


def point_query(fs, gate, camera, xy, scale, threshold, alive, config) -> torch.Tensor:
    """The point prompt: the scale-gated feature map of ``camera``, the
    normalised feature at pixel ``xy`` = (x, y), and the Gaussians whose
    gated feature is within ``threshold`` cosine of it; a bool mask over
    ``alive``'s capacity."""
    gated = queries.gate_features(fs.point_features, gate, scale)
    fmap = render_feature_map(fs, gated, camera, config)
    x, y = xy
    prompt = fmap[y, x]
    prompt = prompt / torch.linalg.norm(prompt).clamp_min(1e-9)
    return queries.segment3d(fs.point_features, gate, scale, prompt[None],
                             threshold=threshold, alive=alive)


def text_query(fs, gate, cams, text_scores, generator, threshold, alive,
               config) -> language.TextSegmentResult:
    """The language flow over ``cams``: the scale transform fitted on all of
    their mask scales, as in contrastive training, and feature maps of the
    normalised point features."""
    device = fs.point_features.device
    all_scales = np.concatenate([np.asarray(c.mask_scales, np.float32).reshape(-1)
                                 for c in cams if c.mask_scales is not None])
    qt = fit_quantile_transform(torch.as_tensor(all_scales, device=device))
    feats_n = fs.point_features / torch.linalg.norm(
        fs.point_features, dim=-1, keepdim=True).clamp_min(1e-9)
    return language.text_segment(
        lambda cam: render_feature_map(fs, feats_n, cam.params, config), cams,
        fs.point_features, gate, qt, text_scores, generator=generator,
        threshold=threshold, alive=alive,
    )


def simple_lift(state, cams, pos, negs, config) -> torch.Tensor:
    """Per-mask CLIP scores → 2D score maps → the mask render's gradient,
    over the views that carry ``clip_features`` and SAM masks."""
    device = state.params.xyz.device
    views, score_maps = [], []
    for cam in cams:
        feats, masks = cam.clip_features, cam.sam_masks
        if feats is None or masks is None:
            continue
        s = clip_text.get_scores(torch.as_tensor(np.asarray(feats, np.float32), device=device),
                                 pos, negs)
        m = torch.as_tensor(np.asarray(masks), device=device).to(torch.float32)
        score_maps.append(clip_text.scores_to_pixel_map(s, m))
        views.append(cam)
    return clip_text.lift_scores_to_3d(views, score_maps, state, config=config)


def main(argv=None):
    from seganygaussians_torch.cli.render import select_device
    from seganygaussians_torch.config import extract, load_cfg, make_parser
    from seganygaussians_torch.models import gaussians as gm
    from seganygaussians_torch.ops.rasterize import RasterConfig
    from seganygaussians_torch.scene import ModelConfig, Scene
    from seganygaussians_torch.seg.scale_gate import load_scale_gate

    parser = make_parser("Prompt segmentation")
    parser.add_argument("--iteration", type=int, default=-1)
    parser.add_argument("--view", type=int, default=0)
    parser.add_argument("--point", type=int, nargs=2, default=None, metavar=("X", "Y"))
    parser.add_argument("--text", type=str, default=None)
    parser.add_argument("--scale", type=float, default=0.5,
                        help="quantile-normalised scale in [0,1]")
    parser.add_argument("--threshold", type=float, default=0.75)
    parser.add_argument("--out", type=str, default="./segmentation_res")
    parser.add_argument("--backend", type=str, default="auto")
    parser.add_argument("--raster_capacity", type=int, default=1 << 20)
    parser.add_argument("--simple_lift", action="store_true",
                        help="text path: direct 2D score-map lifting instead of the full "
                             "cluster-graph pipeline")
    parser.add_argument("--text_threshold", type=float, default=0.85,
                        help="final similarity threshold of the language flow")
    parser.add_argument("--device", type=str, default="cuda")
    args = parser.parse_args(argv)
    if args.point is None and args.text is None:
        parser.error("provide --point X Y or --text 'prompt'")

    device = select_device(args.device)
    cfg = extract(ModelConfig, args)
    saved = load_cfg(cfg.model_path, "cfg_args")
    if saved and not cfg.source_path and "model" in saved:
        cfg.source_path = saved["model"].get("source_path", "")
    cfg.need_masks = args.text is not None
    cfg.need_features = args.text is not None

    scene = Scene(
        cfg, need_scene=True, need_features_model=True, load_iteration=-1,
        feature_load_iteration=args.iteration, target="contrastive_feature", mode="eval",
        shuffle=False, device=device,
    )
    raster_cfg = RasterConfig(capacity=args.raster_capacity, backend=args.backend)
    fs = scene.feature_gaussians
    gate = load_scale_gate(os.path.join(cfg.model_path, "point_cloud",
                                        f"iteration_{scene.feature_loaded_iter}",
                                        "scale_gate.pt"), device=device)
    cams = scene.get_train_cameras()
    alive = scene.gaussians.alive

    with torch.no_grad():
        if args.point is not None:
            mask3d = point_query(fs, gate, cams[args.view].params, args.point, args.scale,
                                 args.threshold, alive, raster_cfg)
        else:
            enc = clip_text.ClipEncoder(device=device)
            print(f"CLIP encoder backend: {enc.backend}")
            pos = torch.as_tensor(enc.encode_text_with_template([args.text]), device=device)
            negs = torch.as_tensor(enc.encode_text(list(clip_text.CANONICAL_NEGATIVES)),
                                   device=device)
            if args.simple_lift:
                mask3d = simple_lift(scene.gaussians, cams, pos, negs, raster_cfg)
            else:
                def text_scores(embeds):
                    e = torch.as_tensor(embeds, dtype=torch.float32, device=device)
                    return clip_text.get_scores(e, pos, negs).cpu().numpy()

                res = text_query(fs, gate, cams, text_scores,
                                 torch.Generator(device=device).manual_seed(0),
                                 args.text_threshold, alive, raster_cfg)
                mask3d = res.mask3d
                print(f"clusters: {len(set(res.labels[res.labels >= 0]))} "
                      f"({int((res.labels < 0).sum())} noise masks), "
                      f"query scales {res.query_scales}")

    os.makedirs(args.out, exist_ok=True)
    n_sel = int(mask3d.sum())
    torch.save(mask3d.cpu(), os.path.join(args.out, "final_mask.pt"))
    scene.gaussians = gm.segment(scene.gaussians, mask3d)
    ply_path = scene.save(scene.loaded_iter or 0, target="seg")
    print(f"selected {n_sel} gaussians → {args.out}/final_mask.pt and {ply_path}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
