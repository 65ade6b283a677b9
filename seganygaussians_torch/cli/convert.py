"""COLMAP structure-from-motion driver.

Counterpart of ``seganygaussians_tpu/cli/convert.py``: feature extraction,
exhaustive matching, the mapper and undistortion on a scene's ``input/``
images through the ``colmap`` executable, the output laid out as
``sparse/0``, and with ``--resize`` the 2×/4×/8× image pyramid (PIL,
Lanczos).  It runs on the host alone: nothing here touches a device.

    python -m seganygaussians_torch.cli.convert -s <scene> [--resize]
"""

from __future__ import annotations

import os
import shutil
import subprocess
import sys
from argparse import ArgumentParser


def _run(cmd: list[str]) -> None:
    print("+", " ".join(cmd), flush=True)
    proc = subprocess.run(cmd)
    if proc.returncode != 0:
        raise SystemExit(
            f"{cmd[0]} {cmd[1]} failed with code {proc.returncode}"
        )


def run_colmap(
    source_path: str,
    camera: str = "OPENCV",
    colmap_executable: str = "",
    no_gpu: bool = True,
    skip_matching: bool = False,
) -> None:
    colmap_cmd = colmap_executable or "colmap"
    if shutil.which(colmap_cmd) is None:
        raise SystemExit(
            f"'{colmap_cmd}' not found on PATH. Install COLMAP or pass "
            "--colmap_executable; alternatively provide a precomputed "
            "sparse/0 (cameras.bin/images.bin/points3D.bin) and skip convert."
        )
    use_gpu = "0" if no_gpu else "1"

    if not skip_matching:
        os.makedirs(os.path.join(source_path, "distorted", "sparse"),
                    exist_ok=True)
        db = os.path.join(source_path, "distorted", "database.db")
        _run([
            colmap_cmd, "feature_extractor",
            "--database_path", db,
            "--image_path", os.path.join(source_path, "input"),
            "--ImageReader.single_camera", "1",
            "--ImageReader.camera_model", camera,
            "--SiftExtraction.use_gpu", use_gpu,
        ])
        _run([
            colmap_cmd, "exhaustive_matcher",
            "--database_path", db,
            "--SiftMatching.use_gpu", use_gpu,
        ])
        # A tight bundle-adjustment tolerance, as the reference's.
        _run([
            colmap_cmd, "mapper",
            "--database_path", db,
            "--image_path", os.path.join(source_path, "input"),
            "--output_path", os.path.join(source_path, "distorted", "sparse"),
            "--Mapper.ba_global_function_tolerance=0.000001",
        ])

    _run([
        colmap_cmd, "image_undistorter",
        "--image_path", os.path.join(source_path, "input"),
        "--input_path", os.path.join(source_path, "distorted", "sparse", "0"),
        "--output_path", source_path,
        "--output_type", "COLMAP",
    ])

    # Everything the undistorter wrote under sparse/ goes to sparse/0.
    sparse = os.path.join(source_path, "sparse")
    os.makedirs(os.path.join(sparse, "0"), exist_ok=True)
    for f in os.listdir(sparse):
        if f != "0":
            shutil.move(os.path.join(sparse, f), os.path.join(sparse, "0", f))


def build_pyramid(source_path: str) -> None:
    """2×/4×/8× downscaled copies of ``images/`` (PIL, Lanczos)."""
    from PIL import Image

    src_dir = os.path.join(source_path, "images")
    for factor in (2, 4, 8):
        out_dir = os.path.join(source_path, f"images_{factor}")
        os.makedirs(out_dir, exist_ok=True)
        for name in os.listdir(src_dir):
            img = Image.open(os.path.join(src_dir, name))
            img.resize(
                (max(1, img.width // factor), max(1, img.height // factor)),
                Image.LANCZOS,
            ).save(os.path.join(out_dir, name))
        print(f"images_{factor}: {len(os.listdir(out_dir))} files", flush=True)


def main(argv=None):
    parser = ArgumentParser("COLMAP converter")
    parser.add_argument("--source_path", "-s", required=True, type=str)
    parser.add_argument("--camera", default="OPENCV", type=str)
    parser.add_argument("--colmap_executable", default="", type=str)
    parser.add_argument("--no_gpu", action="store_true")
    parser.add_argument("--skip_matching", action="store_true")
    parser.add_argument("--resize", action="store_true")
    args = parser.parse_args(argv)

    run_colmap(
        args.source_path, camera=args.camera,
        colmap_executable=args.colmap_executable,
        no_gpu=args.no_gpu, skip_matching=args.skip_matching,
    )
    if args.resize:
        build_pyramid(args.source_path)
    print("Done.")
    return 0


if __name__ == "__main__":
    sys.exit(main())
