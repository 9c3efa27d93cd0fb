"""Typed configuration for the proving stack.

Replaces the reference's scattered compile-time knobs (CMake cache options,
VNT.h tree depth, hardcoded /usr/local/prfKey paths — SURVEY.md §5.6) with
one dataclass. Values can be overridden via environment variables prefixed
BMTPU_ (e.g. BMTPU_KEY_DIR, BMTPU_MERKLE_DEPTH, BMTPU_LANES)."""

from __future__ import annotations

import dataclasses
import os


def _env(name: str, default, cast=None):
    v = os.environ.get(f"BMTPU_{name}")
    if v is None:
        return default
    return (cast or type(default))(v)


@dataclasses.dataclass
class Config:
    # key storage (reference: /usr/local/prfKey, mintcgo.cpp:302)
    key_dir: str = dataclasses.field(
        default_factory=lambda: _env("KEY_DIR", os.path.join(
            os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
            "reference_harness", "prfKey")))
    # in-circuit Merkle depth (VNT.h:6 = 8; 20 is the production setting)
    merkle_depth: int = dataclasses.field(
        default_factory=lambda: _env("MERKLE_DEPTH", 8))
    # MSM kernel tuning (window 0 = auto-select per query size;
    # lanes 0 = backend-tuned default: 32768 on TPU — the bench-tuned
    # value — 2048 on CPU where the segmented-reduction loop is compiled
    # per lane-chunk)
    msm_lanes: int = dataclasses.field(
        default_factory=lambda: _env("LANES", 0))
    msm_window: int = dataclasses.field(
        default_factory=lambda: _env("WINDOW", 0))
    # mesh shape for multi-chip sharding ("" = single chip)
    mesh_axis_points: int = dataclasses.field(
        default_factory=lambda: _env("MESH_POINTS", 1))
    mesh_axis_batch: int = dataclasses.field(
        default_factory=lambda: _env("MESH_BATCH", 1))


_config = None


def get_config() -> Config:
    global _config
    if _config is None:
        _config = Config()
    return _config
