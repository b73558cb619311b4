"""Preset configurations for the paper's two partitioner variants — port
of ``repro.core.partitioner``.

The preset builders ``fast_config`` / ``strong_config`` spell the paper's
configurations; ``resolve_config`` turns (preset, explicit config,
epsilon, seed) into a validated ``PartitionerConfig``.
"""
from __future__ import annotations

from typing import Optional

from . import metrics
from .deep_mgp import PartitionerConfig


def fast_config(seed: int = 0, **overrides) -> PartitionerConfig:
    """dKaMinPar-Fast (paper §6): C=2000, 3 LP iterations."""
    return PartitionerConfig(contraction_limit=overrides.pop(
        "contraction_limit", 2000), cluster_iterations=overrides.pop(
        "cluster_iterations", 3), seed=seed, **overrides)


def strong_config(seed: int = 0, **overrides) -> PartitionerConfig:
    """dKaMinPar-Strong (paper §6): C=5000, 5 LP iterations, more reps."""
    return PartitionerConfig(contraction_limit=overrides.pop(
        "contraction_limit", 5000), cluster_iterations=overrides.pop(
        "cluster_iterations", 5), ip_repetitions=overrides.pop(
        "ip_repetitions", 6), refine_iterations=overrides.pop(
        "refine_iterations", 3), seed=seed, **overrides)


PRESETS = {"fast": fast_config, "strong": strong_config}


def resolve_config(preset: str = "fast",
                   config: Optional[PartitionerConfig] = None,
                   epsilon: float = 0.03, seed: int = 0
                   ) -> PartitionerConfig:
    """One place that turns (preset, explicit config, epsilon, seed) into
    a validated ``PartitionerConfig`` — an explicit config wins."""
    if config is not None:
        return config.validate()
    try:
        builder = PRESETS[preset]
    except KeyError:
        raise ValueError(f"unknown preset {preset!r}; "
                         f"expected one of {sorted(PRESETS)}") from None
    return builder(seed=seed, epsilon=epsilon).validate()


__all__ = ["fast_config", "strong_config", "resolve_config",
           "PRESETS", "PartitionerConfig", "metrics"]
