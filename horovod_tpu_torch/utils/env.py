"""Environment knobs, read once at ``init()``.

Port of ``horovod_tpu/utils/env.py``'s ``EngineConfig``.  Knobs that
Horovod users set keep Horovod's names (``HOROVOD_FUSION_THRESHOLD``,
``HOROVOD_CYCLE_TIME``, ``HOROVOD_TIMELINE``, ``HOROVOD_STALL_CHECK_*``,
``HOROVOD_AUTOTUNE*``), so launch scripts carry over; the port's own are
``HVD_TORCH_*``.
"""

from __future__ import annotations

import dataclasses
import os

HOROVOD_TIMELINE = "HOROVOD_TIMELINE"
HOROVOD_FUSION_THRESHOLD = "HOROVOD_FUSION_THRESHOLD"
HOROVOD_CYCLE_TIME = "HOROVOD_CYCLE_TIME"
HOROVOD_STALL_CHECK_DISABLE = "HOROVOD_STALL_CHECK_DISABLE"
HOROVOD_STALL_CHECK_TIME = "HOROVOD_STALL_CHECK_TIME"
HOROVOD_HIERARCHICAL_ALLREDUCE = "HOROVOD_HIERARCHICAL_ALLREDUCE"
HOROVOD_AUTOTUNE = "HOROVOD_AUTOTUNE"
HOROVOD_AUTOTUNE_LOG = "HOROVOD_AUTOTUNE_LOG"
HOROVOD_AUTOTUNE_WARMUP_SAMPLES = "HOROVOD_AUTOTUNE_WARMUP_SAMPLES"
HOROVOD_AUTOTUNE_STEADY_STATE_SAMPLES = "HOROVOD_AUTOTUNE_STEADY_STATE_SAMPLES"
HVD_TORCH_NATIVE_CONTROLLER = "HVD_TORCH_NATIVE_CONTROLLER"
HVD_TORCH_CONTROLLER_TRANSPORT = "HVD_TORCH_CONTROLLER_TRANSPORT"

# Horovod's defaults (reference horovod/common/operations.cc:151, :155,
# :273): a 64 MiB fusion buffer, a 5 ms cycle, a 60 s stall warning.
DEFAULT_FUSION_THRESHOLD_BYTES = 64 * 1024 * 1024
DEFAULT_CYCLE_TIME_MS = 5.0
DEFAULT_STALL_WARNING_TIME_S = 60.0


def _get_int(name: str, default: int) -> int:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return int(raw)
    except ValueError:
        return default


def _get_float(name: str, default: float) -> float:
    raw = os.environ.get(name)
    if raw is None or raw == "":
        return default
    try:
        return float(raw)
    except ValueError:
        return default


def _get_bool(name: str, default: bool = False) -> bool:
    raw = os.environ.get(name)
    if raw is None:
        return default
    return raw.strip().lower() not in ("", "0", "false", "no", "off")


@dataclasses.dataclass
class EngineConfig:
    """Snapshot of the knobs, taken once when the process group starts.
    ``fusion_threshold_bytes`` and ``cycle_time_ms`` are the only fields
    that change afterwards: the autotuner moves them and the eager engine
    reads both on every cycle."""

    fusion_threshold_bytes: int = DEFAULT_FUSION_THRESHOLD_BYTES
    timeline_file: str | None = None
    cycle_time_ms: float = DEFAULT_CYCLE_TIME_MS
    stall_check_enabled: bool = True
    stall_warning_time_s: float = DEFAULT_STALL_WARNING_TIME_S
    # Read so that a launch script carrying it is refused, not ignored:
    # the eager engine raises NotImplementedError while it is set.
    hierarchical_allreduce: bool = False
    # The native coordination engine (native/src/): "auto" runs it when
    # the world has more than one rank, "on" always, "off" never.
    native_controller: str = "auto"
    # Its control plane: "tcp:<rank0-host>:<port>" or "local:<name>".
    controller_transport: str | None = None
    autotune: bool = False
    autotune_log: str | None = None
    autotune_warmup_samples: int = 3
    autotune_steady_state_samples: int = 10

    @classmethod
    def from_env(cls) -> "EngineConfig":
        return cls(
            fusion_threshold_bytes=_get_int(
                HOROVOD_FUSION_THRESHOLD, DEFAULT_FUSION_THRESHOLD_BYTES),
            timeline_file=os.environ.get(HOROVOD_TIMELINE) or None,
            cycle_time_ms=_get_float(HOROVOD_CYCLE_TIME,
                                     DEFAULT_CYCLE_TIME_MS),
            stall_check_enabled=not _get_bool(HOROVOD_STALL_CHECK_DISABLE),
            stall_warning_time_s=_get_float(HOROVOD_STALL_CHECK_TIME,
                                            DEFAULT_STALL_WARNING_TIME_S),
            hierarchical_allreduce=_get_bool(HOROVOD_HIERARCHICAL_ALLREDUCE),
            native_controller=os.environ.get(
                HVD_TORCH_NATIVE_CONTROLLER, "auto").strip().lower(),
            controller_transport=(
                os.environ.get(HVD_TORCH_CONTROLLER_TRANSPORT) or None),
            autotune=_get_bool(HOROVOD_AUTOTUNE),
            autotune_log=os.environ.get(HOROVOD_AUTOTUNE_LOG) or None,
            autotune_warmup_samples=_get_int(
                HOROVOD_AUTOTUNE_WARMUP_SAMPLES, 3),
            autotune_steady_state_samples=_get_int(
                HOROVOD_AUTOTUNE_STEADY_STATE_SAMPLES, 10),
        )
