"""ctypes binding to the native coordination engine (the repo's ``native/src/``).

The port's counterpart of ``horovod_tpu/native/__init__.py``: the same
framework-agnostic C++ controller (``controller.cc``, ``transport.cc``,
``c_api.cc``) and the same wire, loaded from a library that
:mod:`horovod_tpu_torch._build` compiles with ``g++`` at first use into
``build/horovod_tpu_torch/`` (never at import).  The controller carries
control-plane metadata only (names, dtypes, shapes, fused batches); the
tensors stay on the card and move by NCCL (gloo on the CPU), one
collective per returned batch.
"""

from __future__ import annotations

import ctypes
import struct
import threading
from dataclasses import dataclass, field

# OpKind / DType wire values: native/src/types.h.
KIND_ALLREDUCE, KIND_ALLGATHER, KIND_BROADCAST, KIND_SPARSE = 0, 1, 2, 3
KIND_ALLTOALL, KIND_REDUCESCATTER, KIND_JOIN = 4, 5, 6

# Dispatch-program codes (types.h OpCode): what a joined rank launches to
# take part in a batch it never submitted.
OP_PLAIN_SUM, OP_PLAIN_AVERAGE, OP_OTHER = 0, 1, 2

_DTYPE_CODES = {
    "uint8": 0, "int8": 1, "uint16": 2, "int16": 3, "int32": 4,
    "int64": 5, "float16": 6, "bfloat16": 7, "float32": 8, "float64": 9,
    "bool": 10, "uint32": 11, "uint64": 12,
}
DTYPE_NAMES = {v: k for k, v in _DTYPE_CODES.items()}

_load_lock = threading.Lock()
_lib = None


class NativeBuildError(RuntimeError):
    pass


def load_library() -> ctypes.CDLL:
    """Load the controller library, building it first if needed."""
    global _lib
    if _lib is not None:
        return _lib
    with _load_lock:
        if _lib is not None:
            return _lib
        from horovod_tpu_torch import _build

        try:
            path = _build.build_controller()
        except RuntimeError as e:
            raise NativeBuildError(str(e)) from e
        lib = ctypes.CDLL(str(path))
        lib.hvdtpu_controller_create.restype = ctypes.c_void_p
        lib.hvdtpu_controller_create.argtypes = [
            ctypes.c_int, ctypes.c_int, ctypes.c_char_p, ctypes.c_longlong,
            ctypes.c_double, ctypes.c_char_p, ctypes.c_int,
        ]
        lib.hvdtpu_controller_destroy.argtypes = [ctypes.c_void_p]
        lib.hvdtpu_controller_submit.restype = ctypes.c_int
        lib.hvdtpu_controller_submit.argtypes = [
            ctypes.c_void_p, ctypes.c_ubyte, ctypes.c_ubyte, ctypes.c_char_p,
            ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int,
            ctypes.c_longlong, ctypes.c_ubyte,
        ]
        lib.hvdtpu_controller_request_shutdown.argtypes = [ctypes.c_void_p]
        out_args = [ctypes.c_void_p,
                    ctypes.POINTER(ctypes.POINTER(ctypes.c_ubyte)),
                    ctypes.POINTER(ctypes.c_uint64)]
        for fn in ("tick", "stall_report", "drain_ticks"):
            f = getattr(lib, f"hvdtpu_controller_{fn}")
            f.restype = ctypes.c_int
            f.argtypes = out_args
        lib.hvdtpu_controller_enable_tick_trace.argtypes = [
            ctypes.c_void_p, ctypes.c_int]
        lib.hvdtpu_controller_set_tuned.argtypes = [
            ctypes.c_void_p, ctypes.c_longlong, ctypes.c_double]
        lib.hvdtpu_free.argtypes = [ctypes.POINTER(ctypes.c_ubyte)]
        _lib = lib
        return _lib


@dataclass
class Batch:
    kind: int
    error: str
    names: list[str] = field(default_factory=list)
    # The wire dtype, the dispatch program and each name's shape: a joined
    # rank rebuilds the collective for tensors it never saw.
    dtype: int = 8  # kF32
    op_code: int = OP_OTHER
    shapes: list[tuple[int, ...]] = field(default_factory=list)


@dataclass
class BatchList:
    shutdown: bool
    batches: list[Batch] = field(default_factory=list)
    # Rank 0's tuned knobs on every response (None: unset), so every rank
    # sees a move in the same tick.
    tuned_threshold_bytes: int | None = None
    tuned_cycle_ms: float | None = None
    # >= 0 once every rank has joined: the last rank to join.
    last_joined: int = -1


def _parse_batch_list(data: bytes) -> BatchList:
    """native/src/wire.h ``SerializeBatchList``, read back."""
    off = 0

    def take(fmt: str):
        nonlocal off
        (v,) = struct.unpack_from(fmt, data, off)
        off += struct.calcsize(fmt)
        return v

    def s():
        nonlocal off
        n = take("<I")
        v = data[off:off + n].decode()
        off += n
        return v

    shutdown = take("<B") != 0
    thr = take("<q")
    cyc_us = take("<q")
    last_joined = take("<i")
    batches = []
    for _ in range(take("<I")):
        kind = take("<B")
        dtype = take("<B")
        op_code = take("<B")
        error = s()
        names = [s() for _ in range(take("<I"))]
        shapes = [tuple(take("<q") for _ in range(take("<I")))
                  for _ in range(len(names))]
        batches.append(Batch(kind, error, names, dtype=dtype,
                             op_code=op_code, shapes=shapes))
    return BatchList(
        shutdown, batches,
        tuned_threshold_bytes=thr if thr >= 0 else None,
        tuned_cycle_ms=cyc_us / 1000.0 if cyc_us >= 0 else None,
        last_joined=last_joined)


class NativeController:
    """One rank's handle on the native coordination controller."""

    def __init__(self, rank: int, size: int, transport_spec: str,
                 fusion_threshold_bytes: int, stall_warning_s: float = 60.0):
        lib = load_library()
        err = ctypes.create_string_buffer(512)
        self._lib = lib
        self._ptr = lib.hvdtpu_controller_create(
            rank, size, transport_spec.encode(), fusion_threshold_bytes,
            stall_warning_s, err, len(err))
        if not self._ptr:
            raise RuntimeError(
                f"native controller init failed: {err.value.decode()}")
        self.rank, self.size = rank, size

    def submit(self, kind: int, dtype: str, name: str,
               shape: tuple[int, ...], root_rank: int = 0,
               group: int = -1, op_code: int = OP_OTHER) -> None:
        """``dtype``: numpy's name (``"float32"``, ``"bfloat16"``, ...)."""
        code = _DTYPE_CODES.get(str(dtype))
        if code is None:
            raise ValueError(f"dtype {dtype} not supported by the native wire")
        arr = (ctypes.c_longlong * len(shape))(*shape)
        rc = self._lib.hvdtpu_controller_submit(
            self._ptr, kind, code, name.encode(), arr, len(shape),
            root_rank, group, op_code)
        if rc != 0:
            raise RuntimeError(f"native submit rejected request {name!r}")

    def submit_join(self) -> None:
        """Set this rank's joined bit: from the next tick its missing
        submissions stop blocking readiness."""
        rc = self._lib.hvdtpu_controller_submit(
            self._ptr, KIND_JOIN, 4, b"__join__", None, 0, 0, -1, OP_OTHER)
        if rc != 0:
            raise RuntimeError("native submit rejected the join request")

    def _bytes(self, fn) -> tuple[int, bytes]:
        out = ctypes.POINTER(ctypes.c_ubyte)()
        n = ctypes.c_uint64()
        rc = fn(self._ptr, ctypes.byref(out), ctypes.byref(n))
        if not out:
            return rc, b""
        try:
            return rc, ctypes.string_at(out, n.value)
        finally:
            self._lib.hvdtpu_free(out)

    def tick(self) -> BatchList:
        """One negotiation round (a collective of every rank's controller):
        gather, match, fuse, broadcast."""
        if not self._ptr:
            return BatchList(shutdown=True)
        rc, data = self._bytes(self._lib.hvdtpu_controller_tick)
        if rc < 0:
            raise RuntimeError("native controller tick failed (transport)")
        return _parse_batch_list(data)

    def request_shutdown(self) -> None:
        self._lib.hvdtpu_controller_request_shutdown(self._ptr)

    def stall_report(self) -> str:
        """Rank 0: the tensors some ranks submitted longer than the stall
        time ago, with the ranks missing (empty elsewhere)."""
        if not self._ptr:
            return ""
        return self._bytes(self._lib.hvdtpu_controller_stall_report)[1].decode()

    def set_tuned(self, threshold_bytes: int = -1,
                  cycle_ms: float = -1.0) -> None:
        """Install rank 0's tuned knobs (negative: unchanged); rank 0's
        controller alone batches, so they govern the world from the next
        tick.  A no-op off rank 0."""
        if self._ptr:
            self._lib.hvdtpu_controller_set_tuned(
                self._ptr, int(threshold_bytes), float(cycle_ms))

    def enable_tick_trace(self, on: bool = True) -> None:
        """Record each rank's request arrivals on rank 0 (the timeline's
        NEGOTIATE ticks).  Off by default."""
        if self._ptr:
            self._lib.hvdtpu_controller_enable_tick_trace(self._ptr, int(on))

    def drain_ticks(self) -> list[tuple[str, int]]:
        """The buffered (tensor name, rank) arrivals (rank 0)."""
        if not self._ptr:
            return []
        text = self._bytes(self._lib.hvdtpu_controller_drain_ticks)[1]
        events = []
        for line in text.decode().splitlines():
            rank_str, _, name = line.partition(" ")
            if name:
                events.append((name, int(rank_str)))
        return events

    def close(self) -> None:
        if self._ptr:
            self._lib.hvdtpu_controller_destroy(self._ptr)
            self._ptr = None

    def __del__(self):  # pragma: no cover - best effort
        try:
            self.close()
        except Exception:
            pass
