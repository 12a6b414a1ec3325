"""Process model: ``init``, ``shutdown``, ``rank``, ``size`` on ``torch.distributed``.

Port of ``horovod_tpu/basics.py`` (``init``, ``shutdown``, ``is_initialized``,
``size``, ``local_size``, ``rank``, ``local_rank``, ``NotInitializedError``).
The JAX package drives every chip of a host from one controller; the port
runs one process per GPU, as Horovod itself does, over one
``torch.distributed`` process group: NCCL for CUDA, gloo for the CPU.

Rank and world come from the launcher's environment, in this order:

* the JAX package's launcher (``horovod_tpu/launch.py``):
  ``HOROVOD_TPU_PROCESS_ID``, ``HOROVOD_TPU_NUM_PROCESSES``,
  ``HOROVOD_TPU_COORDINATOR`` (``host:port``), ``HOROVOD_TPU_LOCAL_RANK``,
  ``HOROVOD_TPU_LOCAL_SIZE``;
* ``torchrun``'s: ``RANK``, ``WORLD_SIZE``, ``MASTER_ADDR``/``MASTER_PORT``,
  ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``.

With neither set, ``init()`` makes a world of one on an in-process store (no
address, no port), as ``hvd.init()`` alone does.  A process group the caller
already started is adopted as it is.
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from horovod_tpu_torch._device import resolve_device
from horovod_tpu_torch.utils.env import EngineConfig


class NotInitializedError(RuntimeError):
    """Raised when the API is used before ``init()``."""


@dataclasses.dataclass
class _State:
    initialized: bool = False
    owns_group: bool = False
    device: torch.device | None = None
    local_rank: int = 0
    local_size: int = 1
    config: EngineConfig | None = None
    generation: int = 0         # bumped by every init(): keys cached groups


_state = _State()


def _env(*names: str) -> str | None:
    for n in names:
        v = os.environ.get(n)
        if v not in (None, ""):
            return v
    return None


def _launch_env() -> dict | None:
    """Rank, world, address and per-host layout from the launcher's
    variables, or None when no launcher set them."""
    rank = _env("HOROVOD_TPU_PROCESS_ID", "RANK")
    world = _env("HOROVOD_TPU_NUM_PROCESSES", "WORLD_SIZE")
    if rank is None or world is None:
        return None
    addr = _env("HOROVOD_TPU_COORDINATOR")
    if addr is None:
        host, port = _env("MASTER_ADDR"), _env("MASTER_PORT")
        if host is None or port is None:
            raise RuntimeError(
                "init(): RANK/WORLD_SIZE are set but no rendezvous address: "
                "set HOROVOD_TPU_COORDINATOR=host:port or MASTER_ADDR and "
                "MASTER_PORT")
        addr = f"{host}:{port}"
    rank, world = int(rank), int(world)
    local_rank = int(_env("HOROVOD_TPU_LOCAL_RANK", "LOCAL_RANK") or 0)
    local_size = int(_env("HOROVOD_TPU_LOCAL_SIZE", "LOCAL_WORLD_SIZE")
                     or world)
    return {"rank": rank, "world": world, "addr": addr,
            "local_rank": local_rank, "local_size": local_size}


def init(device: str | torch.device | None = None) -> None:
    """Start the process group.  ``device``: ``None`` means the card (this
    process's GPU, ``local_rank``), ``"cpu"`` the gloo CPU world.
    Idempotent."""
    if _state.initialized:
        return
    dev = resolve_device(device)
    backend = "nccl" if dev.type == "cuda" else "gloo"
    env = _launch_env()
    local_rank, local_size = 0, 1
    if env is not None:
        local_rank, local_size = env["local_rank"], env["local_size"]
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    owns = False
    if not dist.is_initialized():
        if env is None:
            dist.init_process_group(backend, store=dist.HashStore(), rank=0,
                                    world_size=1)
        else:
            dist.init_process_group(backend, init_method=f"tcp://{env['addr']}",
                                    rank=env["rank"], world_size=env["world"])
        owns = True
    _state.owns_group = owns
    _state.device = dev
    _state.local_rank, _state.local_size = local_rank, local_size
    _state.config = EngineConfig.from_env()
    _state.generation += 1
    _state.initialized = True


def shutdown() -> None:
    """Tear the process group down (if ``init`` started it).  Idempotent."""
    if not _state.initialized:
        return
    if _state.owns_group and dist.is_initialized():
        dist.destroy_process_group()
    _state.initialized = False
    _state.owns_group = False
    _state.device = None
    _state.config = None


def is_initialized() -> bool:
    return _state.initialized


def _require_init() -> _State:
    if not _state.initialized:
        raise NotInitializedError(
            "horovod_tpu_torch has not been initialized; use "
            "horovod_tpu_torch.basics.init().")
    return _state


def size() -> int:
    """Number of processes (one per GPU) in the world."""
    _require_init()
    return dist.get_world_size()


def rank() -> int:
    """This process's index in the world."""
    _require_init()
    return dist.get_rank()


def local_size() -> int:
    """Processes on this host."""
    return _require_init().local_size


def local_rank() -> int:
    """This process's index among the host's processes (its GPU)."""
    return _require_init().local_rank


def device() -> torch.device:
    """The device this process computes and communicates on."""
    return _require_init().device


def config() -> EngineConfig:
    return _require_init().config
