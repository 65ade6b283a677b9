"""Reflection-based CLI flag groups + persisted config.

Counterpart of ``seganygaussians_tpu/config.py``.  ``add_group`` turns
dataclass fields into argparse flags (bools become store_true); the groups
are ``ModelConfig`` and ``PipelineConfig`` (``make_parser``), ``TrainHyper``,
which the trainer CLI adds, and ``ContrastiveHyper``
(``make_contrastive_parser``).  Configs persist as JSON (``cfg_args.json``),
and the reader also accepts the reference's ``Namespace(...)`` repr without
``eval``.
"""

from __future__ import annotations

import argparse
import ast
import dataclasses
import json
import os
from typing import Any, Optional

from seganygaussians_torch.models.gaussians import TrainHyper  # noqa: F401 (a group)
from seganygaussians_torch.scene import ModelConfig
from seganygaussians_torch.train.contrastive_trainer import ContrastiveHyper

_SHORTHANDS = {
    "source_path": "s",
    "model_path": "m",
    "feature_model_path": "f",
    "images": "i",
    "resolution": "r",
    "white_background": "w",
}


@dataclasses.dataclass
class PipelineConfig:
    """Pipeline flags, kept for CLI surface parity: SH evaluation and cov3D
    already run in plain tensor code, so these toggles change nothing."""

    convert_SHs_python: bool = False
    compute_cov3D_python: bool = False
    debug: bool = False


def add_group(parser: argparse.ArgumentParser, dc_type, title: str) -> None:
    group = parser.add_argument_group(title)
    for f in dataclasses.fields(dc_type):
        name = f.name
        default = f.default
        flags = [f"--{name}"]
        if name in _SHORTHANDS:
            flags.append(f"-{_SHORTHANDS[name]}")
        if f.type in ("bool", bool):
            group.add_argument(*flags, action="store_true", default=default)
        else:
            typ = type(default) if default is not None else str
            group.add_argument(*flags, type=typ, default=default)


def extract(dc_type, args: argparse.Namespace):
    names = {f.name for f in dataclasses.fields(dc_type)}
    return dc_type(**{k: v for k, v in vars(args).items() if k in names})


def save_cfg(model_path: str, cfgs: dict[str, Any], name: str = "cfg_args") -> None:
    """Persist configs as ``<name>.json``."""
    os.makedirs(model_path, exist_ok=True)
    payload = {
        k: dataclasses.asdict(v) if dataclasses.is_dataclass(v) else v
        for k, v in cfgs.items()
    }
    with open(os.path.join(model_path, name + ".json"), "w") as f:
        json.dump(payload, f, indent=1)


def load_cfg(model_path: str, name: str = "cfg_args") -> Optional[dict]:
    """Load a persisted config: our JSON, or the reference's
    ``Namespace(k=v, ...)`` repr (parsed without eval)."""
    json_path = os.path.join(model_path, name + ".json")
    if os.path.exists(json_path):
        with open(json_path) as f:
            return json.load(f)
    ref_path = os.path.join(model_path, name)
    if os.path.exists(ref_path):
        with open(ref_path) as f:
            text = f.read().strip()
        if text.startswith("Namespace(") and text.endswith(")"):
            node = ast.parse(text.replace("Namespace", "dict", 1), mode="eval")
            out = {}
            for kw in node.body.keywords:
                try:
                    out[kw.arg] = ast.literal_eval(kw.value)
                except (ValueError, SyntaxError):
                    pass
            return {"model": out}
    return None


def make_parser(description: str = "") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    add_group(parser, ModelConfig, "Loading Parameters")
    add_group(parser, PipelineConfig, "Pipeline Parameters")
    return parser


def make_contrastive_parser(description: str = "") -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(description=description)
    add_group(parser, ModelConfig, "Loading Parameters")
    add_group(parser, PipelineConfig, "Pipeline Parameters")
    add_group(parser, ContrastiveHyper, "Optimization Parameters")
    return parser
