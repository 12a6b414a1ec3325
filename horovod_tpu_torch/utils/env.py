"""Environment knobs, read once at ``init()``.

Port of the subset of ``horovod_tpu/utils/env.py`` that the data-parallel
training path reads: the fusion threshold.  The knob keeps Horovod's name,
``HOROVOD_FUSION_THRESHOLD`` (bytes), so launch scripts carry over.
"""

from __future__ import annotations

import dataclasses
import os

HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"

# Horovod's 64 MiB fusion buffer (reference horovod/common/operations.cc:151).
DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024


def _get_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        return default


@dataclasses.dataclass
class EngineConfig:
    """Snapshot of the knobs, taken once when the process group starts."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES

    @classmethod
    def from_env(cls) -> "EngineConfig":
        return cls(fusion_threshold_bytes=_get_int(
            HOROVOD_FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES))
