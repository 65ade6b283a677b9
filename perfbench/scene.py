"""Seeded inputs of a configuration: Gaussians, cameras, ground truth, masks
and affinity features, all made from ``--seed`` on the device in a few large
calls.

A configuration's ``layout`` places its Gaussians in parts, each a share of
the count: ``ellipsoid`` (filled), ``shell`` (a spherical shell between two
radii), ``disc`` (a horizontal disc) and ``box`` (the six faces of a box, by
area).  Each part sets its log-scale, opacity logit and colour; rotations are
uniform.  Cameras sit on the orbit, looking at its centre, y up, with the
matrices ``seganygaussians_torch.ops.camera`` uses (row-vector convention,
znear 0.01, zfar 100).  Everything is numpy or torch, so the reference reads
the same inputs as the program.
"""

from __future__ import annotations

import math

import numpy as np
import torch

SH_C0 = 0.28209479177387814


def generator(seed: int, salt: int, device) -> torch.Generator:
    """One stream per kind of input, so that adding one moves no other."""
    return torch.Generator(device=device).manual_seed((int(seed) * 1_000_003 + salt) % (1 << 63))


def _part_points(part: dict, n: int, g, device) -> torch.Tensor:
    def rand(*shape):
        return torch.rand(*shape, generator=g, device=device)

    center = torch.tensor(part["center"], dtype=torch.float32, device=device)
    kind = part["shape"]
    if kind == "ellipsoid":
        d = torch.randn(n, 3, generator=g, device=device)
        d = d / d.norm(dim=1, keepdim=True)
        r = rand(n, 1) ** (1.0 / 3.0)
        return center + d * r * torch.tensor(part["radii"], device=device)
    if kind == "shell":
        d = torch.randn(n, 3, generator=g, device=device)
        d = d / d.norm(dim=1, keepdim=True)
        lo, hi = part["radius_range"]
        return center + d * (lo + (hi - lo) * rand(n, 1))
    if kind == "disc":
        a = 2 * math.pi * rand(n)
        r = part["radius"] * rand(n).sqrt()
        return center + torch.stack([r * torch.cos(a), 0.02 * torch.randn(
            n, generator=g, device=device), r * torch.sin(a)], dim=1)
    if kind == "box":
        half = torch.tensor(part["half_extent"], dtype=torch.float32, device=device)
        h = half.tolist()
        areas = torch.tensor([h[1] * h[2], h[1] * h[2], h[0] * h[2], h[0] * h[2],
                              h[0] * h[1], h[0] * h[1]], device=device)
        face = torch.multinomial(areas, n, replacement=True, generator=g)
        p = (2 * rand(n, 3) - 1) * half
        axis, sign = face // 2, (face % 2) * 2 - 1
        p[torch.arange(n, device=device), axis] = sign.float() * half[axis]
        return center + p
    raise ValueError(f"unknown layout shape {kind!r}")


def gaussians(config: dict, seed: int, device) -> dict:
    """The 59 stored parameters of ``num_gaussians`` Gaussians (pre-activation,
    the PLY's layout): xyz 3, features_dc 3, features_rest 45, scaling 3,
    rotation 4, opacity 1."""
    n = int(config["num_gaussians"])
    g = generator(seed, 1, device)
    rest = (config["sh_degree"] + 1) ** 2 - 1
    parts = config["layout"]
    counts = [int(n * p["share"]) for p in parts]
    counts[-1] = n - sum(counts[:-1])
    xyz, scale_mu, scale_sd, opa_mu, opa_sd, color = [], [], [], [], [], []
    for part, k in zip(parts, counts):
        xyz.append(_part_points(part, k, g, device))
        for lst, key in ((scale_mu, "log_scale"), (opa_mu, "opacity_logit")):
            lst.append(torch.full((k, 1), float(part[key][0]), device=device))
        for lst, key in ((scale_sd, "log_scale"), (opa_sd, "opacity_logit")):
            lst.append(torch.full((k, 1), float(part[key][1]), device=device))
        color.append(torch.tensor(part["color"], device=device).expand(k, 3))
    noise = torch.randn(n, 5 + 3 + 4, generator=g, device=device)
    rgb = torch.cat(color) + 0.15 * noise[:, 5:8]
    return {
        "xyz": torch.cat(xyz),
        "features_dc": ((rgb - 0.5) / SH_C0)[:, None, :],
        "features_rest": 0.05 * torch.randn(n, rest, 3, generator=g, device=device),
        "scaling": torch.cat(scale_mu) + torch.cat(scale_sd) * noise[:, 0:3],
        "rotation": noise[:, 8:12],
        "opacity": torch.cat(opa_mu) + torch.cat(opa_sd) * noise[:, 3:4],
    }


def look_at(eye, center, fovy: float, width: int, height: int) -> dict:
    """A camera at ``eye`` looking at ``center`` (COLMAP axes: x right, y
    down, z forward), as row-vector world_view and full_proj matrices."""
    eye, center = np.asarray(eye, np.float64), np.asarray(center, np.float64)
    fovx = 2.0 * math.atan(math.tan(fovy / 2.0) * width / height)
    fwd = (center - eye) / np.linalg.norm(center - eye)
    right = np.cross(fwd, [0.0, 1.0, 0.0])
    right /= np.linalg.norm(right)
    down = -np.cross(right, fwd)
    rot = np.stack([right, down, fwd])  # rows: the camera's axes in the world
    w2v = np.eye(4)
    w2v[:3, :3], w2v[:3, 3] = rot, -rot @ eye
    znear, zfar = 0.01, 100.0
    tx, ty = math.tan(fovx / 2.0), math.tan(fovy / 2.0)
    proj = np.zeros((4, 4))
    proj[0, 0], proj[1, 1] = 1.0 / tx, 1.0 / ty
    proj[3, 2], proj[2, 2], proj[2, 3] = 1.0, zfar / (zfar - znear), -zfar * znear / (zfar - znear)
    world_view = w2v.T
    return {"world_view": world_view.astype(np.float32),
            "full_proj": (world_view @ proj.T).astype(np.float32),
            "cam_center": eye.astype(np.float32), "width": int(width), "height": int(height),
            "tan_fovx": tx, "tan_fovy": ty}


def orbit_camera(config: dict, azimuth: float, elevation: float) -> dict:
    o = config["orbit"]
    c = np.asarray(o["center"], np.float64)
    ce, se = math.cos(elevation), math.sin(elevation)
    eye = c + o["radius"] * np.array([ce * math.sin(azimuth), se, ce * math.cos(azimuth)])
    return look_at(eye, c, config["fovy"], config["width"], config["height"])


def views(config: dict, seed: int) -> list[dict]:
    """The scene's training views: evenly round the orbit from a seeded
    start, each with a seeded jitter of elevation."""
    rng = np.random.default_rng([int(seed), 2])
    v = int(config["views"])
    start = rng.uniform(0, 2 * math.pi)
    el = config["orbit"]["elevation"] + rng.uniform(-0.08, 0.08, v)
    return [orbit_camera(config, start + 2 * math.pi * i / v, float(el[i])) for i in range(v)]


def spatial_extent(cams: list[dict]) -> float:
    """NeRF++'s normalisation radius: 1.1 × the largest camera distance from
    the cameras' mean centre (3DGS's ``cameras_extent``)."""
    centers = np.stack([c["cam_center"] for c in cams]).astype(np.float64)
    return float(1.1 * np.linalg.norm(centers - centers.mean(0), axis=1).max())


def images(config: dict, seed: int, device) -> torch.Tensor:
    """(V, H, W, 3) ground truth in [0, 1]: smooth seeded colour fields with
    fine noise."""
    g = generator(seed, 3, device)
    v, h, w = int(config["views"]), config["height"], config["width"]
    coarse = torch.rand(v, 3, 12, 18, generator=g, device=device)
    img = torch.nn.functional.interpolate(coarse, size=(h, w), mode="bilinear",
                                          align_corners=False).permute(0, 2, 3, 1)
    img = img + 0.03 * torch.randn(v, h, w, 3, generator=g, device=device)
    return img.clamp(0.0, 1.0).contiguous()


def masks(config: dict, seed: int, view: int, device) -> tuple[torch.Tensor, np.ndarray]:
    """One view's SAM-style stack: (K, H, W) bool discs and boxes with radii
    from a third of the width down to a fortieth, and a 3D scale per mask that
    falls with its size."""
    rng = np.random.default_rng([int(seed), 4, view])
    k, h, w = int(config["masks_per_view"]), config["height"], config["width"]
    radii = np.sort(w * rng.uniform(0.025, 0.33, k))[::-1].copy()
    cx, cy = rng.uniform(0, w, k), rng.uniform(0, h, k)
    t = lambda a: torch.tensor(a, dtype=torch.float32, device=device)[:, None, None]  # noqa: E731
    ys = torch.arange(h, device=device, dtype=torch.float32)[None, :, None]
    xs = torch.arange(w, device=device, dtype=torch.float32)[None, None, :]
    dx, dy, r = xs - t(cx), ys - t(cy), t(radii)
    disc = dx * dx + dy * dy < r * r
    box = (dx.abs() < r) & (dy.abs() < 0.7 * r)
    odd = (torch.arange(k, device=device) % 2 == 1)[:, None, None]
    scales = (radii / w * 4.0 * rng.uniform(0.9, 1.1, k)).astype(np.float32)
    return torch.where(odd, box, disc), scales


def features(config: dict, xyz: torch.Tensor, seed: int) -> tuple[torch.Tensor, dict]:
    """Trained-looking affinity features: each Gaussian takes the unit
    centre of its spatial cell's cluster plus noise; and a scale gate
    (w (1, D), b (D,)) as torch's Linear(1, D) initialises it."""
    device = xyz.device
    f = config["feature"]
    d, clusters = int(f["dim"]), int(f["clusters"])
    g = generator(seed, 5, device)
    centers = torch.randn(clusters, d, generator=g, device=device)
    centers = centers / centers.norm(dim=1, keepdim=True)
    cell = torch.floor(xyz / f["cluster_cell"]).long()
    key = (cell[:, 0] * 73856093) ^ (cell[:, 1] * 19349663) ^ (cell[:, 2] * 83492791)
    feats = centers[key.remainder(clusters)] + f["noise"] * torch.randn(
        xyz.shape[0], d, generator=g, device=device)
    gate = {"w": 2 * torch.rand(1, d, generator=g, device=device) - 1,
            "b": 2 * torch.rand(d, generator=g, device=device) - 1}
    return feats, gate
