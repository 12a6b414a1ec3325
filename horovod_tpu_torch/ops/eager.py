"""The eager engine: async named-tensor collectives with fusion cycles.

Port of ``horovod_tpu/ops/eager.py`` (the reference's background
coordination engine, horovod/common/operations.cc: ``BackgroundThreadLoop``
:1493-1764, ``RunLoopOnce`` :1795-2007, ``PerformOperation`` :734-1420)
under the reference's own process model, one process per GPU:

* **Negotiation.**  Each process enqueues named collectives in its own
  order.  With more than one rank, the native controller (the repo's
  ``native/src/``, through :mod:`horovod_tpu_torch.native`) gathers every
  rank's requests on rank 0, matches them, fuses them and broadcasts the
  batches, and every rank dispatches those batches in that order.  Without
  it (``HVD_TORCH_NATIVE_CONTROLLER=off``, or no transport), fusion decided
  by each process's flush timing would pair different buckets across ranks,
  so only caller-delimited groups fuse there (``_fuse_key``) and solo ops
  are dispatched in enqueue order.
* **Tensor Fusion.**  One flat buffer a bucket (``torch.cat`` on the
  engine's stream), one ``all_reduce(async_op=True)`` over it;
  ``HOROVOD_FUSION_THRESHOLD`` and ``HOROVOD_CYCLE_TIME`` keep their meaning.
* **Execution.**  The engine owns a process group of the whole world,
  created at its start (the reference's engine owns its communicators),
  so its collectives pair up by their own issue order whatever the
  synchronous API does meanwhile on the default group.  On the card it
  issues from its own CUDA stream: every input carries an event recorded on
  the producer's stream at enqueue (the reference's ``TorchReadyEvent``),
  which the engine's stream waits on before the fusion copy; the result is
  marked by an event after the collective, and ``synchronize`` makes the
  caller's stream wait on it.
* **Stall check** (operations.cc:1424-1470): a thread warns about tensors
  that some ranks enqueued and others did not.

Each process passes its own tensor, as in the reference Horovod; the JAX
package's rank-major form has no counterpart here.
"""

from __future__ import annotations

import collections
import contextlib
import dataclasses
import hashlib
import itertools
import os
import sys
import threading
import time
import zlib
from typing import Any, Sequence

import torch
import torch.distributed as dist

from horovod_tpu_torch import basics, metrics as metrics_mod, native
from horovod_tpu_torch import timeline as timeline_mod
from horovod_tpu_torch.basics import HorovodInternalError
from horovod_tpu_torch.ops import fusion
from horovod_tpu_torch.ops.collective_ops import (Adasum, Average,
                                                  ProcessSet, Sum, _ReduceOp,
                                                  _is_quantized,
                                                  _reduce_start, _resolve_op)
from horovod_tpu_torch.ops.compression import Compression, TopKCompressor
from horovod_tpu_torch.ops.handle_manager import HandleManager


@dataclasses.dataclass
class _PendingOp:
    kind: str        # allreduce | allgather | broadcast | sparse | alltoall | reducescatter
    handle: int
    tensor: torch.Tensor           # this process's input
    name: str
    op: _ReduceOp = Sum
    compression: Any = Compression.none
    root_rank: int = 0
    # allgather: every rank's dim 0; alltoall: the [n, n] split matrix.
    sizes: Any = None
    topk: TopKCompressor | None = None
    group_id: int | None = None    # caller-delimited fusion group
    process_set: ProcessSet | None = None
    no_fuse: bool = False          # never share a fusion bucket
    # May a joined rank stand in for this op with zeros?  True for data
    # allreduces (hvd.join), False for rendezvous ops such as barrier.
    join_identity: bool = True
    ready: Any = None              # CUDA event on the producer's stream
    enqueued_at: float = 0.0

    def wire_shape(self) -> tuple[int, ...]:
        """The shape the controller validates, the same on every rank:
        ragged gathers and uneven all-to-alls give their padded shape (the
        JAX frontend's padding)."""
        rest = tuple(self.tensor.shape[1:])
        if self.kind == "allgather" and self.sizes is not None:
            return (max(self.sizes),) + rest
        if self.kind == "alltoall" and self.sizes is not None:
            n = len(self.sizes)
            return (n * max(1, max(max(r) for r in self.sizes)),) + rest
        return tuple(self.tensor.shape)


def _nbytes(t: torch.Tensor) -> int:
    return int(t.numel()) * t.element_size()


def _dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).removeprefix("torch.")


def _op_end_args(p: _PendingOp) -> dict:
    """dtype and shape on an op's END event (reference timeline.cc:170-188)."""
    return {"dtype": _dtype_name(p.tensor.dtype),
            "shape": list(p.tensor.shape)}


class _Flight:
    """One dispatched collective: its ``Work`` (None where the route ran to
    its end at dispatch), ``finish()`` giving its outputs, and on the card
    a CUDA event recorded on the engine's stream after the outputs were
    computed there (the host does not wait at dispatch)."""

    def __init__(self, work, finish, stream):
        self._work = work
        self._finish = finish
        self._lock = threading.Lock()
        self._out: list[torch.Tensor] | None = None
        self.event = None
        self._device = None
        self._waited: set[int] = set()     # streams made to wait already
        if stream is not None:
            self._device = stream.device
            if work is not None:
                work.wait()      # the engine's stream waits on NCCL's
            self._out = finish()
            self._finish = None
            self.event = torch.cuda.Event()
            self.event.record(stream)

    def is_ready(self) -> bool:
        if self.event is not None:
            return self.event.query()
        return self._work is None or self._work.is_completed()

    def synchronize(self) -> None:
        """Block the host until the collective is done (the autotuner's
        probe)."""
        if self.event is not None:
            self.event.synchronize()
        else:
            self.outputs()

    def outputs(self) -> list[torch.Tensor]:
        """The outputs; on the card the caller's current stream is made to
        wait on the collective first and the outputs' memory is recorded on
        it, once a stream (a bucket's outputs share one buffer, and every
        tensor of the bucket reads them)."""
        if self.event is not None:
            stream = torch.cuda.current_stream(self._device)
            with self._lock:
                if stream.cuda_stream not in self._waited:
                    self._waited.add(stream.cuda_stream)
                    stream.wait_event(self.event)
                    storages = {}
                    for t in self._out:
                        storages.setdefault(t.untyped_storage().data_ptr(), t)
                    for t in storages.values():
                        t.record_stream(stream)
            return self._out
        with self._lock:
            if self._out is None:
                if self._work is not None:
                    self._work.wait()
                self._out = self._finish()
                self._finish = None
            return self._out


class _Output:
    """A handle's result: output ``index`` of a :class:`_Flight`."""

    __slots__ = ("flight", "index")

    def __init__(self, flight: _Flight, index: int):
        self.flight, self.index = flight, index

    def is_ready(self) -> bool:
        return self.flight.is_ready()

    def value(self) -> torch.Tensor:
        return self.flight.outputs()[self.index]


class EagerEngine:
    """Background engine: queue → cycle tick → negotiate → fuse → dispatch.

    One instance per :func:`basics.init`, made at the first eager op."""

    def __init__(self, cfg, timeline=None):
        self.config = cfg
        self.handles = HandleManager()
        self.timeline = timeline
        self.device = basics.device()
        self.size, self.rank = basics.size(), basics.rank()
        # The engine's own group of the whole world: its collectives pair up
        # by the engine's issue order alone.
        self.group = dist.new_group(list(range(self.size)))
        # HOROVOD_HIERARCHICAL_ALLREDUCE: this rank's node group and its
        # cross-node group (None: the flat route).
        self.local_group = self.cross_group = None
        self.hier_local = 1
        if cfg.hierarchical_allreduce:
            self._make_hierarchy(basics.local_size())
        self._ps_groups: dict[tuple, Any] = {}
        self._stream = (torch.cuda.Stream(self.device)
                        if self.device.type == "cuda" else None)
        self._lock = threading.Lock()
        self._flush_lock = threading.Lock()
        self._queue: list[_PendingOp] = []
        self._shutdown = threading.Event()
        self._tick = threading.Event()
        self._queued = threading.Event()    # set by every enqueue
        self.controller = self._maybe_native_controller(cfg)
        if self.controller is not None and self.timeline is not None:
            self.controller.enable_tick_trace()
        self._submitted: dict[str, _PendingOp] = {}
        # hvd.join: while active, batches with names this rank never
        # submitted are filled with zeros (_join_fill); the response that
        # reports every rank joined leaves its last joiner here.
        self._join_active = False
        self._join_result: int | None = None
        self.autotuner = None
        if cfg.autotune:
            from horovod_tpu_torch.autotune import Autotuner

            if self.controller is not None:
                # Rank 0 batches, so rank 0 tunes: each move goes into its
                # controller and rides every response to the other ranks.
                if self.rank == 0:
                    self.autotuner = Autotuner(
                        cfg, warmup_samples=cfg.autotune_warmup_samples,
                        window_flushes=cfg.autotune_steady_state_samples,
                        log_path=cfg.autotune_log,
                        on_move=self.controller.set_tuned)
            elif self.size > 1:
                # Per-rank tuners would move to different thresholds at
                # different times and split groups differently per rank.
                print("WARNING: HOROVOD_AUTOTUNE=1 ignored: a multi-rank "
                      "world tunes only through the native controller "
                      "(HVD_TORCH_NATIVE_CONTROLLER=on), where rank 0 "
                      "tunes and every rank follows its moves.",
                      file=sys.stderr)
            else:
                self.autotuner = Autotuner(
                    cfg, warmup_samples=cfg.autotune_warmup_samples,
                    window_flushes=cfg.autotune_steady_state_samples,
                    log_path=cfg.autotune_log)
        # Every key is seeded here, so that engine_stats()'s unlocked copy
        # never races a first insertion.
        self.stats: dict[str, int] = collections.Counter({
            "ops_enqueued": 0, "batches_dispatched": 0, "tensors_fused": 0,
            "allreduce_bytes": 0, "errors": 0, "stall_warnings": 0,
        })
        self.recent_negotiate_s: collections.deque[float] = (
            collections.deque(maxlen=256))
        self._cycle_thread = threading.Thread(
            target=self._cycle_loop, name="horovod_tpu_torch-engine",
            daemon=True)
        self._cycle_thread.start()
        self._stall_thread: threading.Thread | None = None
        if cfg.stall_check_enabled:
            self._stall_thread = threading.Thread(
                target=self._stall_loop, name="horovod_tpu_torch-stall",
                daemon=True)
            self._stall_thread.start()

    def _make_hierarchy(self, local: int) -> None:
        """The two-level allreduce's groups (reference
        operations.cc:1070-1223; the JAX engine's (dcn, ici) mesh,
        horovod_tpu/ops/eager.py:121-145): rank r sits on node
        ``r // local`` at local rank ``r % local``, the launcher's
        numbering.  One group per node, then one per local rank across
        the nodes, every ``new_group`` on every rank in this order (each
        is a collective of the whole world).  A world that does not
        factor warns, as the JAX engine does, and stays flat."""
        n = self.size
        if not (local > 1 and n % local == 0 and n // local > 1):
            print("WARNING: HOROVOD_HIERARCHICAL_ALLREDUCE=1 ignored: "
                  f"world of {n} ranks does not factor into (cross, "
                  f"local={local}) groups with both extents > 1; "
                  "dispatching over the flat group.  Set "
                  "HOROVOD_TPU_LOCAL_SIZE (or LOCAL_WORLD_SIZE) to a "
                  "divisor of the world size to choose the inner extent.",
                  file=sys.stderr)
            return
        for node in range(n // local):
            ranks = list(range(node * local, (node + 1) * local))
            g = dist.new_group(ranks)
            if self.rank in ranks:
                self.local_group = g
        for lr in range(local):
            ranks = list(range(lr, n, local))
            g = dist.new_group(ranks)
            if self.rank in ranks:
                self.cross_group = g
        self.hier_local = local

    def _mark_error(self, handle: int, err: Exception) -> None:
        self.handles.mark_error(handle, err)
        self.stats["errors"] += 1

    def _maybe_native_controller(self, cfg):
        """``auto``: the controller when the world has more than one rank;
        ``on``: always; ``off``: never."""
        mode = (cfg.native_controller or "auto").lower()
        if mode in ("off", "0", "false", "no"):
            return None
        if mode == "auto" and self.size == 1:
            return None
        try:
            native.load_library()
        except (native.NativeBuildError, OSError) as e:
            if mode != "auto":
                raise RuntimeError(
                    "HVD_TORCH_NATIVE_CONTROLLER=on but the controller "
                    "library could not be built or loaded (g++ on "
                    f"native/src): {e}") from e
            self._warn_python_coordination(
                f"the native controller could not be built or loaded ({e})")
            return None
        spec = cfg.controller_transport
        if spec is None:
            if self.size > 1:
                if mode != "auto":
                    raise RuntimeError(
                        "HVD_TORCH_NATIVE_CONTROLLER=on in a multi-rank "
                        "world requires HVD_TORCH_CONTROLLER_TRANSPORT "
                        "(e.g. tcp:<rank0-host>:<port>)")
                self._warn_python_coordination(
                    "HVD_TORCH_CONTROLLER_TRANSPORT is not set; set it to "
                    "tcp:<rank0-host>:<port> to enable true negotiation")
                return None
            spec = f"local:engine-{os.getpid()}"
        return native.NativeController(
            rank=self.rank, size=self.size, transport_spec=spec,
            fusion_threshold_bytes=cfg.fusion_threshold_bytes,
            stall_warning_s=cfg.stall_warning_time_s)

    @staticmethod
    def _warn_python_coordination(why: str) -> None:
        print("WARNING: horovod_tpu_torch eager collectives in a multi-rank "
              "world fall back to Python coordination: " + why + ".  Only "
              "caller-delimited groups (grouped_allreduce_eager) will fuse, "
              "and agreement across ranks relies on identical program "
              "order.", file=sys.stderr)

    def ps_group(self, ps: ProcessSet):
        """The engine's group for process set ``ps``; made on the caller's
        thread at enqueue, since making a group is a collective of the
        whole world and must follow program order."""
        if ps.ranks[-1] >= self.size:
            raise ValueError(
                f"process set {ps.ranks} exceeds world size {self.size}")
        g = self._ps_groups.get(ps.ranks)
        if g is None:
            g = self._ps_groups[ps.ranks] = dist.new_group(list(ps.ranks))
        return g

    # ------------------------------------------------------------------ queue

    def enqueue(self, pending: _PendingOp) -> int:
        """EnqueueTensorAllreduce/Allgather/Broadcast (reference
        operations.cc:2099-2215)."""
        self.enqueue_many([pending])
        return pending.handle

    def enqueue_many(self, pendings: list[_PendingOp]) -> None:
        """Enqueue a caller-delimited group at once (one lock), so that no
        flush sees part of it: its bucket composition is then the same on
        every rank and every call."""
        now = time.monotonic()
        for p in pendings:
            p.enqueued_at = now
            if p.tensor.is_cuda:
                p.ready = torch.cuda.Event()
                p.ready.record(torch.cuda.current_stream(p.tensor.device))
            if self.timeline:
                self.timeline.start(p.name,
                                    timeline_mod.NEGOTIATE + "_"
                                    + p.kind.upper())
                if self.controller is None:
                    self.timeline.instant(p.name, "NEGOTIATE_TICK_ALL")
        with self._lock:
            if self._shutdown.is_set():
                raise HorovodInternalError(
                    "horovod_tpu_torch engine has been shut down")
            self._queue.extend(pendings)
            self.stats["ops_enqueued"] += len(pendings)
        self._queued.set()

    def _fuse_key(self, p: _PendingOp):
        """Fusability key for :func:`fusion.plan_buckets` (the reference's
        same-type merge predicate, operations.cc:1916-1943).  In a
        multi-rank world without the controller, only caller-delimited
        groups fuse: fusion by local flush timing would differ by rank."""
        if p.kind != "allreduce" or p.op is Adasum or p.no_fuse:
            # Adasum's inner products are per tensor; no_fuse callers (int8
            # error feedback, whose residual models this tensor's own
            # blocks) opt out.
            return ("solo", p.handle)
        ps = p.process_set.ranks if p.process_set is not None else None
        base = ("ar", p.op.name, p.compression, str(p.tensor.dtype), ps)
        if p.group_id is not None:
            return base + (("grp", p.group_id),)
        if self.size > 1:
            return base + (("solo", p.handle),)
        return base

    def flush(self) -> None:
        """Drain the queue now: negotiate or plan, fuse, dispatch (one
        ``RunLoopOnce`` tick, operations.cc:1795-2007).  Serialized under
        ``_flush_lock``, so that the cycle thread, ``poll`` and
        ``synchronize`` cannot interleave their dispatch order."""
        tune_sample = None
        with self._flush_lock:
            with self._lock:
                batch, self._queue = self._queue, []
            if self.controller is not None:
                tune_sample = self._flush_via_controller(batch)
            elif batch:
                for p in batch:
                    self._end_negotiate(p)
                buckets = fusion.plan_buckets(
                    batch, self.config.fusion_threshold_bytes,
                    nbytes=lambda p: _nbytes(p.tensor), key=self._fuse_key)
                ar_bytes, probe = 0, None
                for bucket in buckets:
                    group = [batch[i] for i in bucket]
                    if group[0].kind == "allreduce":
                        flight, nb = self._dispatch_allreduce_group(group)
                        if flight is not None:
                            ar_bytes += nb
                            probe = flight
                    else:
                        self._dispatch_single(group[0])
                if self.autotuner is not None and ar_bytes:
                    tune_sample = (ar_bytes, probe)
        # Scored outside the flush lock: closing a window waits for the
        # probe, and other flushes must not wait for that.
        if tune_sample is not None and self.autotuner is not None:
            self.autotuner.observe(*tune_sample)

    _KIND_CODES = {"allreduce": native.KIND_ALLREDUCE,
                   "allgather": native.KIND_ALLGATHER,
                   "broadcast": native.KIND_BROADCAST,
                   "sparse": native.KIND_SPARSE,
                   "alltoall": native.KIND_ALLTOALL,
                   "reducescatter": native.KIND_REDUCESCATTER}

    def _controller_group(self, p: _PendingOp) -> int:
        """Fusability (reduce op, compression, process set, caller group)
        as the controller's int64 ``group``: a pure function of the key,
        never of encounter order, which differs by rank."""
        if p.kind != "allreduce":
            return -1
        comp = getattr(p.compression, "__name__", None) or type(
            p.compression).__name__
        ps = p.process_set.ranks if p.process_set is not None else ()
        token = f"{p.op.name}:{comp}:{ps}".encode()
        if p.group_id is not None:
            token += b":grp:" + str(p.group_id).encode()
        if p.no_fuse or p.op is Adasum:
            # Only the same name from the other ranks may join its batch:
            # Adasum's dot products are per tensor here too, as in
            # _fuse_key (the JAX package's controller token lets Adasum
            # tensors fuse).
            token += b":" + p.name.encode()
        return int.from_bytes(hashlib.sha1(token).digest()[:7], "big")

    @staticmethod
    def _op_code(p: _PendingOp) -> int:
        """A joined rank can stand in with zeros only for the plain
        Sum/Average allreduce; everything else is OP_OTHER."""
        if (p.kind == "allreduce" and p.process_set is None
                and p.compression is Compression.none and p.join_identity):
            if p.op is Sum:
                return native.OP_PLAIN_SUM
            if p.op is Average:
                return native.OP_PLAIN_AVERAGE
        return native.OP_OTHER

    def _join_fill(self, b, ops: list[_PendingOp]) -> list[_PendingOp] | None:
        """Complete a batch this joined rank submitted in part or not at
        all: zeros stand in for the missing names, so that it issues the
        same collective as its peers (Horovod ≥ 0.21's join).  None when
        the batch cannot be joined."""
        if (not self._join_active or b.kind != native.KIND_ALLREDUCE
                or b.op_code not in (native.OP_PLAIN_SUM,
                                     native.OP_PLAIN_AVERAGE)):
            return None
        dtype = getattr(torch, native.DTYPE_NAMES.get(b.dtype, "float32"))
        op = Average if b.op_code == native.OP_PLAIN_AVERAGE else Sum
        by_name = {p.name: p for p in ops}
        with self._engine_stream():
            return [by_name.get(name) or _PendingOp(
                kind="allreduce", handle=-1, name=name, op=op,
                tensor=torch.zeros(shape, dtype=dtype, device=self.device))
                for name, shape in zip(b.names, b.shapes)]

    def _flush_via_controller(self, batch: list[_PendingOp]):
        """Submit new requests, run one negotiation tick, dispatch the
        agreed batches in their order.  Returns ``(allreduce_bytes,
        probe)`` where this rank tunes and the tick moved allreduce
        traffic, else None."""
        for p in batch:
            if p.name in self._submitted:
                # The reference rejects a duplicate in-flight name
                # (operations.cc:2124-2134).
                self._end_negotiate(p)
                self._mark_error(p.handle, RuntimeError(
                    f"Duplicate tensor name in flight: {p.name}"))
                continue
            try:
                self.controller.submit(
                    self._KIND_CODES[p.kind], _dtype_name(p.tensor.dtype),
                    p.name, p.wire_shape(), root_rank=p.root_rank,
                    group=self._controller_group(p), op_code=self._op_code(p))
            except Exception as e:
                # A rejected request fails its own handle, not the flush.
                self._end_negotiate(p)
                self._mark_error(p.handle, e)
                continue
            self._submitted[p.name] = p
        try:
            bl = self.controller.tick()
        except Exception as e:
            # A broken control plane strands every outstanding op: fail
            # their handles so that waiters return.
            err = HorovodInternalError(f"control plane failed: {e}")
            err.__cause__ = e
            for p in self._submitted.values():
                self._end_negotiate(p)
                self._mark_error(p.handle, err)
            self._submitted.clear()
            raise err
        if self.timeline:
            for tname, trank in self.controller.drain_ticks():
                self.timeline.instant(tname, f"NEGOTIATE_TICK_r{trank}")
        # Rank 0's tuned knobs ride every response; the tuner's owner has
        # them already (a response built before its move would roll back).
        if self.autotuner is None:
            if bl.tuned_threshold_bytes is not None:
                self.config.fusion_threshold_bytes = bl.tuned_threshold_bytes
            if bl.tuned_cycle_ms is not None:
                self.config.cycle_time_ms = bl.tuned_cycle_ms
        if bl.last_joined >= 0:
            with self._lock:
                self._join_result = bl.last_joined
        ar_bytes, probe = 0, None
        for b in bl.batches:
            ops = [self._submitted.pop(n) for n in b.names
                   if n in self._submitted]
            if len(ops) != len(b.names) and not b.error:
                full = self._join_fill(b, ops)
                if full is not None:
                    for p in ops:
                        self._end_negotiate(p)
                    flight, nb = self._dispatch_allreduce_group(full)
                    if flight is not None and ops:
                        ar_bytes += nb
                        probe = flight
                    continue
            if not ops:
                continue
            for p in ops:
                self._end_negotiate(p)
            if b.error:
                err = RuntimeError(b.error)
                for p in ops:
                    self._mark_error(p.handle, err)
            elif ops[0].kind == "allreduce":
                flight, nb = self._dispatch_allreduce_group(ops)
                if flight is not None:
                    ar_bytes += nb
                    probe = flight
            else:
                for p in ops:
                    self._dispatch_single(p)
        if bl.shutdown:
            # Ops no rank completed before the shutdown response error
            # rather than hang (reference operations.cc:278-283).
            err = HorovodInternalError(
                "horovod_tpu_torch has been shut down; collective was not "
                "completed by all ranks")
            for p in self._submitted.values():
                self._end_negotiate(p)
                self._mark_error(p.handle, err)
            self._submitted.clear()
            self._shutdown.set()
        if self.autotuner is not None and ar_bytes:
            return (ar_bytes, probe)
        return None

    def _end_negotiate(self, p: _PendingOp) -> None:
        if p.enqueued_at:
            wait = time.monotonic() - p.enqueued_at
            metrics_mod.DEFAULT.histogram("hvd.negotiate_s").observe(wait)
            self.recent_negotiate_s.append(wait)
        if self.timeline:
            self.timeline.end(p.name,
                              timeline_mod.NEGOTIATE + "_" + p.kind.upper())

    def join(self) -> int:
        """``hvd.join()``: this rank is out of data.  Block until every rank
        joined, standing in with zeros meanwhile for the other ranks' plain
        Sum/Average allreduces; return the last rank to join.  A multi-rank
        world needs the native controller; a world of one returns 0."""
        if self.controller is None:
            if self.size > 1:
                raise RuntimeError(
                    "hvd.join() needs the native controller "
                    "(HVD_TORCH_NATIVE_CONTROLLER=on and a controller "
                    "transport); Python coordination cannot negotiate "
                    "joined ranks")
            self.flush()
            return self.size - 1
        self.flush()
        with self._lock:
            self._join_result = None
            self._join_active = True
        try:
            self.controller.submit_join()
            while True:
                self.flush()
                with self._lock:
                    r = self._join_result
                if r is not None:
                    return r
                if self._shutdown.is_set():
                    raise HorovodInternalError(
                        "engine shut down while waiting in hvd.join()")
                time.sleep(max(self.config.cycle_time_ms, 0.5) / 1000.0)
        finally:
            with self._lock:
                self._join_active = False
                self._join_result = None

    def _cycle_loop(self) -> None:
        """A tick every ``HOROVOD_CYCLE_TIME`` ms (reference
        operations.cc:1795, :1661-1685), re-read each time: the autotuner
        moves it."""
        while not self._shutdown.is_set():
            if self.controller is None:
                # Nothing to negotiate with other ranks: sleep until an
                # enqueue, so that an idle engine never takes the GIL from
                # the thread that launches the kernels.
                self._queued.wait()
            period = max(self.config.cycle_time_ms, 0.1) / 1000.0
            self._tick.wait(timeout=period)
            self._tick.clear()
            self._queued.clear()
            try:
                self.flush()
                tl = self.timeline
                if tl is not None and tl.mark_cycles:
                    tl.instant("_engine", "CYCLE_START")
            except Exception:  # pragma: no cover - keep ticking
                import traceback

                traceback.print_exc(file=sys.stderr)

    def _stall_loop(self) -> None:
        """Warn about tensors waiting on other ranks (reference
        CheckForStalledTensors, operations.cc:1424-1470)."""
        warn_after = self.config.stall_warning_time_s
        while not self._shutdown.is_set():
            self._shutdown.wait(timeout=min(warn_after / 4.0, 15.0))
            if self._shutdown.is_set():
                return
            now = time.monotonic()
            with self._lock:
                stalled = [p.name for p in self._queue
                           if now - p.enqueued_at > warn_after]
            if self.controller is not None:
                report = self.controller.stall_report()
                if report:
                    stalled.append(report)
            if stalled:
                self.stats["stall_warnings"] += 1
                print("WARNING: One or more tensors were submitted to be "
                      "reduced, gathered or broadcasted by subset of ranks "
                      "and are waiting for remainder of ranks for more than "
                      f"{int(warn_after)} seconds. Stalled ops: "
                      + ", ".join(sorted(stalled)), file=sys.stderr)

    def shutdown(self) -> None:
        """Flush, send the shutdown through the control plane, stop the
        threads, close the controller (reference operations.cc:1699-1729)."""
        try:
            self.flush()
            if self.controller is not None:
                self.controller.request_shutdown()
                self.flush()
        finally:
            self._shutdown.set()
            self._tick.set()
            self._queued.set()
            if self._cycle_thread.is_alive():
                self._cycle_thread.join(timeout=5)
            if self._stall_thread is not None and self._stall_thread.is_alive():
                self._stall_thread.join(timeout=5)
            if self.controller is not None:
                self.controller.close()

    # --------------------------------------------------------------- dispatch

    def _engine_stream(self):
        return (torch.cuda.stream(self._stream) if self._stream is not None
                else contextlib.nullcontext())

    @contextlib.contextmanager
    def _issue(self, ops: Sequence[_PendingOp]):
        """Issue on the engine's stream, after each input's ready event;
        the inputs are recorded on that stream so that the allocator keeps
        them until it is done with them."""
        with self._engine_stream():
            if self._stream is not None:
                for p in ops:
                    if p.ready is not None:
                        self._stream.wait_event(p.ready)
                    p.tensor.record_stream(self._stream)
            yield

    def _group_for(self, ps: ProcessSet | None):
        return self.group if ps is None else self.ps_group(ps)

    def _dispatch_allreduce_group(self, group: list[_PendingOp]):
        """Dispatch one fused bucket: one flat buffer, one collective.
        Returns ``(flight or None, bucket bytes)``."""
        names = [p.name for p in group]
        nbytes = sum(_nbytes(p.tensor) for p in group)
        tl = self.timeline   # snapshot: start_timeline may attach one
        if tl:
            for n in names:
                tl.start(n, "ALLREDUCE", {"fused_with": len(group) - 1})
                tl.start(n, timeline_mod.DISPATCH)
        try:
            ps = group[0].process_set
            with timeline_mod.span("hvd.dispatch", timeline=False), \
                    self._issue(group):
                flat = torch.cat([p.tensor.reshape(-1) for p in group])
                work, finish = self._reduce_bucket(
                    flat, group[0].op, group[0].compression, ps)
                numels = [p.tensor.numel() for p in group]
                shapes = [p.tensor.shape for p in group]

                def outputs():
                    return [piece.view(shape) for piece, shape
                            in zip(finish().split(numels), shapes)]
                flight = _Flight(work, outputs, self._stream)
            for i, p in enumerate(group):
                if p.handle >= 0:       # a joined rank's zeros: no handle
                    self.handles.mark_dispatched(p.handle, _Output(flight, i))
            self.stats["batches_dispatched"] += 1
            if len(group) > 1:
                self.stats["tensors_fused"] += len(group)
            self.stats["allreduce_bytes"] += nbytes
            metrics_mod.DEFAULT.counter("hvd.allreduce_bytes").inc(nbytes)
            return flight, nbytes
        except Exception as e:
            for p in group:
                if p.handle >= 0:
                    self._mark_error(p.handle, e)
            return None, nbytes
        finally:
            if tl:
                for n, p in zip(names, group):
                    tl.end(n, timeline_mod.DISPATCH)
                    tl.end(n, "ALLREDUCE", _op_end_args(p))

    def _reduce_bucket(self, flat: torch.Tensor, op: _ReduceOp,
                       compression, ps: ProcessSet | None):
        """Start a fused bucket's reduction: the two-level route for Sum
        and Average over the whole world with a cast wire, else the flat
        one.  The JAX engine runs every op over the (dcn, ici) mesh, where
        the other ops' results equal the flat ones; they stay flat here."""
        if (self.local_group is None or ps is not None
                or op not in (Sum, Average) or _is_quantized(compression)):
            return _reduce_start(flat, op, compression, ps,
                                 group=self._group_for(ps))
        return self._hierarchical_start(flat, op, compression)

    def _hierarchical_start(self, buf: torch.Tensor, op: _ReduceOp,
                            compression):
        """Horovod's hierarchical allreduce (operations.cc:1070-1223):
        reduce-scatter within the node, allreduce of the shard across the
        nodes, allgather within the node.  The wire is padded to a
        multiple of the node size and cut back after; Average divides
        once, by the world size."""
        wire, ctx = compression.compress(buf)
        n = wire.numel()
        pad = (-n) % self.hier_local
        if pad:
            wire = torch.cat([wire, wire.new_zeros(pad)])
        shard = wire.new_empty(wire.numel() // self.hier_local)
        dist.reduce_scatter_tensor(shard, wire, op=dist.ReduceOp.SUM,
                                   group=self.local_group)
        dist.all_reduce(shard, op=dist.ReduceOp.SUM, group=self.cross_group)
        out = torch.empty_like(wire)
        work = dist.all_gather_into_tensor(out, shard, group=self.local_group,
                                           async_op=True)

        def finish():
            res = out[:n]
            if op is Average:
                res = (res.div_(self.size) if res.is_floating_point()
                       else res / self.size)
            return compression.decompress(res, ctx)
        return work, finish

    def _dispatch_single(self, p: _PendingOp) -> None:
        tl = self.timeline
        if tl:
            tl.start(p.name, p.kind.upper())
        try:
            with timeline_mod.span("hvd.dispatch", timeline=False), \
                    self._issue([p]):
                work, finish = getattr(self, f"_start_{p.kind}")(p)
                flight = _Flight(work, lambda: [finish()], self._stream)
            self.handles.mark_dispatched(p.handle, _Output(flight, 0))
            self.stats["batches_dispatched"] += 1
        except Exception as e:
            self._mark_error(p.handle, e)
        finally:
            if tl:
                tl.end(p.name, p.kind.upper(), _op_end_args(p))

    def _start_broadcast(self, p: _PendingOp):
        """Members of the process set (everyone without one) receive the
        root's value; non-members keep their own."""
        out = p.tensor.clone()
        ps = p.process_set
        if ps is not None and not ps.is_member():
            return None, lambda: out
        wire = out.view(torch.int8) if out.dtype == torch.bool else out
        work = dist.broadcast(wire, src=p.root_rank,
                              group=self._group_for(ps), async_op=True)
        return work, lambda: out

    def _start_allgather(self, p: _PendingOp):
        """Every rank's rows in rank order (with a process set, the
        members' rows in set order); dim 0 may differ by rank: each pads
        to the largest and the padding is cut away."""
        sizes = p.sizes
        top = max(sizes)
        x = p.tensor.contiguous()
        if x.shape[0] < top:
            x = torch.cat([x, x.new_zeros((top - x.shape[0],) + x.shape[1:])])
        out = x.new_empty((self.size * x.numel(),))
        work = dist.all_gather_into_tensor(out, x.reshape(-1),
                                           group=self.group, async_op=True)
        ranks = (range(self.size) if p.process_set is None
                 else p.process_set.ranks)

        def finish():
            rows = out.view((self.size,) + tuple(x.shape))
            return torch.cat([rows[r, :sizes[r]] for r in ranks])
        return work, finish

    def _start_alltoall(self, p: _PendingOp):
        """Rows ``S[me, j]`` of this rank's tensor go to rank j; the output
        is what every rank sent here, in rank order."""
        S = p.sizes
        me = self.rank
        x = p.tensor.contiguous()
        recv = [int(S[r][me]) for r in range(self.size)]
        out = x.new_empty((sum(recv),) + tuple(x.shape[1:]))
        work = dist.all_to_all_single(out, x, recv,
                                      [int(c) for c in S[me]],
                                      group=self.group, async_op=True)
        return work, lambda: out

    def _start_reducescatter(self, p: _PendingOp):
        x = p.tensor.contiguous()
        out = x.new_empty((x.shape[0] // self.size,) + tuple(x.shape[1:]))
        work = dist.reduce_scatter_tensor(out, x, op=dist.ReduceOp.SUM,
                                          group=self.group, async_op=True)
        if self._stream is None:
            # gloo's reduce-scatter Work reports completion only once it is
            # waited on, so poll() would never turn true: finish it here.
            work.wait()
            work = None
        return work, lambda: out / self.size if p.op is Average else out

    def _start_sparse(self, p: _PendingOp):
        out = p.topk.sparse_allreduce(p.tensor, average=p.op is Average,
                                      group=self.group)
        return None, lambda: out


# ---------------------------------------------------------------------------
# Module API (the reference's horovod/torch/mpi_ops.py surface).
# ---------------------------------------------------------------------------

_group_counter = itertools.count()
_name_lock = threading.Lock()
_name_seq = 0


def _auto_name(prefix: str) -> str:
    global _name_seq
    with _name_lock:
        _name_seq += 1
        return f"{prefix}.noname.{_name_seq}"


def _engine() -> EagerEngine:
    st = basics._require_init()
    with st.lock:
        if st.engine is None:
            if st.timeline is None:
                # A start_timeline() before the first eager op may have
                # installed one already.
                st.timeline = timeline_mod.maybe_create(
                    st.config.timeline_file)
            st.engine = EagerEngine(st.config, st.timeline)
        return st.engine


def _enqueue(kind: str, tensor: torch.Tensor, name: str | None,
             **fields) -> int:
    eng = _engine()
    name = name or _auto_name(kind)
    h = eng.handles.allocate(name)
    eng.enqueue(_PendingOp(kind=kind, handle=h, tensor=tensor, name=name,
                           **fields))
    return h


def _prepare_allreduce(tensor, average, name, *, op, compression, group_id,
                       process_set, no_fuse, join_identity=True):
    """(engine, ready-to-enqueue op): shared by the async path and the
    grouped one, which enqueues its members at once."""
    op = _resolve_op(average, op)
    eng = _engine()
    if process_set is not None:
        eng.ps_group(process_set)
    name = name or _auto_name("allreduce")
    h = eng.handles.allocate(name)
    return eng, _PendingOp(
        kind="allreduce", handle=h, tensor=tensor, name=name, op=op,
        compression=compression, group_id=group_id, process_set=process_set,
        no_fuse=no_fuse, join_identity=join_identity)


def allreduce_async(tensor: torch.Tensor, average: bool | None = None,
                    name: str | None = None, *, op: _ReduceOp = Sum,
                    compression=Compression.none, group_id: int | None = None,
                    process_set: ProcessSet | None = None,
                    no_fuse: bool = False, join_identity: bool = True) -> int:
    """Async all-reduce of this process's ``tensor``; returns a handle
    (reference horovod/torch/mpi_ops.py:156-176).  ``process_set``
    restricts it to member ranks (every rank calls it; non-members get
    their input back); ``no_fuse=True`` keeps it out of every bucket."""
    eng, pending = _prepare_allreduce(
        tensor, average, name, op=op, compression=compression,
        group_id=group_id, process_set=process_set, no_fuse=no_fuse,
        join_identity=join_identity)
    eng.enqueue(pending)
    return pending.handle


def allreduce(tensor: torch.Tensor, average: bool | None = None,
              name: str | None = None, *, op: _ReduceOp = Sum,
              compression=Compression.none,
              process_set: ProcessSet | None = None) -> torch.Tensor:
    """Blocking all-reduce (reference horovod/torch/mpi_ops.py:60-109)."""
    return synchronize(allreduce_async(tensor, average, name, op=op,
                                       compression=compression,
                                       process_set=process_set))


def sparse_allreduce_async(tensor: torch.Tensor, name: str | None = None, *,
                           average: bool = False, ratio: float = 0.01,
                           k: int | None = None) -> int:
    """The fork's top-k sparse allreduce (reference
    horovod/torch/__init__.py:46-83): top-k, all-gather, scatter-add."""
    return _enqueue("sparse", tensor, name,
                    op=Average if average else Sum,
                    topk=TopKCompressor(ratio=ratio, k=k))


def sparse_allreduce(tensor: torch.Tensor, name: str | None = None, *,
                     average: bool = False, ratio: float = 0.01,
                     k: int | None = None) -> torch.Tensor:
    return synchronize(sparse_allreduce_async(tensor, name, average=average,
                                              ratio=ratio, k=k))


MAX_GATHER_NDIM = 8


def negotiate_gather_sizes(shape: Sequence[int], dtype: torch.dtype,
                           name: str | None = None) -> list[int]:
    """Every rank's dim 0 for a ragged allgather, exchanged through the
    engine (so it keeps its place among the queued ops), after checking
    that the ranks agree on ndim, dtype and the other dims: a mismatch
    raises the same ``ValueError`` on every rank (the reference's
    unequal-first-dim negotiation, operations.cc:841-901)."""
    return negotiate_gather_sizes_many([shape], [dtype], name)[0]


def negotiate_gather_sizes_many(shapes: Sequence[Sequence[int]],
                                dtypes: Sequence[torch.dtype],
                                name: str | None = None) -> list[list[int]]:
    """:func:`negotiate_gather_sizes` for K tensors in one exchange.  The
    member count goes first, in its own fixed-width exchange, so that ranks
    that disagree on K raise together instead of mismatching the digest's
    width."""
    k = len(shapes)
    n = basics.size()
    dev = basics.device()
    if n > 1:
        ks = _gather_equal(torch.tensor([k], dtype=torch.int64, device=dev),
                           None if name is None else f"{name}.shapes.k")
        for r in range(n):
            if int(ks[r]) != k:
                raise ValueError(
                    f"allgather: group member count differs on rank {r}: "
                    f"rank {r} negotiates {int(ks[r])} member(s) vs local "
                    f"{k} — every rank must pass the same-length tensor "
                    "list to a grouped allgather")
    digest = torch.zeros((k, 2 + MAX_GATHER_NDIM), dtype=torch.int64)
    crcs = []
    for i, (shape, dtype) in enumerate(zip(shapes, dtypes)):
        ndim = len(shape)
        if ndim < 1:
            raise ValueError("allgather expects a tensor with >= 1 dim")
        if ndim > MAX_GATHER_NDIM:
            raise ValueError(f"allgather supports up to {MAX_GATHER_NDIM} "
                             f"dims, got {ndim}")
        # crc32, not hash(): Python's str hash differs by process.
        crcs.append(zlib.crc32(_dtype_name(dtype).encode()) & 0x7FFFFFFF)
        digest[i, 0] = ndim
        digest[i, 1] = crcs[-1]
        digest[i, 2:2 + ndim] = torch.tensor(list(shape))
    every = _gather_equal(digest.reshape(-1).to(dev),
                          None if name is None else f"{name}.shapes")
    every = every.cpu().reshape(n, k, 2 + MAX_GATHER_NDIM).tolist()
    out = []
    for i, shape in enumerate(shapes):
        ndim = len(shape)
        member = f" (group member {i})" if k > 1 else ""
        for r in range(n):
            if every[r][i][0] != ndim or every[r][i][1] != crcs[i]:
                raise ValueError(
                    "allgather: per-rank tensors must share ndim and dtype; "
                    f"rank {r} disagrees{member} ({every[r][i][:2]} vs "
                    f"{[ndim, crcs[i]]})")
            if every[r][i][3:2 + ndim] != list(shape[1:]):
                raise ValueError(
                    "allgather: per-rank tensors must agree on all dims "
                    f"except dim 0; rank {r} has trailing{member} "
                    f"{every[r][i][3:2 + ndim]} vs local {list(shape[1:])}")
        out.append([every[r][i][2] for r in range(n)])
    return out


def _gather_equal(tensor: torch.Tensor, name: str | None) -> torch.Tensor:
    """Allgather through the engine of a 1-D tensor whose length every
    rank shares: ``[n * len]``."""
    return synchronize(allgather_async(
        tensor, name, sizes=(tensor.shape[0],) * basics.size()))


def allgather_async(tensor: torch.Tensor, name: str | None = None, *,
                    process_set: ProcessSet | None = None,
                    sizes: Sequence[int] | None = None) -> int:
    """Async allgather along dim 0, in rank order; ranks may disagree on
    dim 0.  ``sizes``, every rank's dim 0, comes from
    :func:`negotiate_gather_sizes` unless given (the negotiation goes
    through the engine and blocks until every rank has called).  With a
    ``process_set``, the result is the members' rows only, in set order
    (every rank calls it)."""
    if tensor.dim() == 0:
        raise ValueError("allgather expects a tensor with >= 1 dim")
    if process_set is not None and process_set.ranks[-1] >= basics.size():
        raise ValueError(f"process set {process_set.ranks} exceeds world "
                         f"size {basics.size()}")
    if sizes is None:
        sizes = negotiate_gather_sizes(tuple(tensor.shape), tensor.dtype,
                                       name=name)
    return _enqueue("allgather", tensor, name, sizes=tuple(sizes),
                    process_set=process_set)


def allgather(tensor: torch.Tensor, name: str | None = None, *,
              process_set: ProcessSet | None = None) -> torch.Tensor:
    return synchronize(allgather_async(tensor, name,
                                       process_set=process_set))


def negotiate_alltoall_splits(splits: Sequence[int], dim0: int,
                              name: str | None = None) -> list[list[int]]:
    """Every rank's split row, exchanged through the engine: ``S[r][j]``
    is how many rows rank r sends to rank j.  The checks that depend on a
    rank's own values (non-negative, summing to its dim 0) run after the
    exchange, against every rank's row, so that a bad rank raises the same
    error everywhere instead of stranding the others."""
    n = basics.size()
    row = [int(s) for s in splits]
    if len(row) != n:
        raise ValueError(f"alltoall splits must have one entry per rank "
                         f"({n}), got {len(row)}")
    rec = torch.tensor(row + [dim0], dtype=torch.int64,
                       device=basics.device())
    every = _gather_equal(rec, None if name is None else f"{name}.splits")
    every = every.cpu().reshape(n, n + 1).tolist()
    for r in range(n):
        if any(c < 0 for c in every[r][:n]):
            raise ValueError(f"alltoall splits must be non-negative; rank "
                             f"{r} sent {every[r][:n]}")
        if sum(every[r][:n]) != every[r][n]:
            raise ValueError(f"alltoall splits sum {sum(every[r][:n])} != "
                             f"tensor dim 0 {every[r][n]} on rank {r}")
    return [every[r][:n] for r in range(n)]


def alltoall_async(tensor: torch.Tensor, splits=None,
                   name: str | None = None) -> int:
    """Async all-to-all (``hvd.alltoall``, Horovod ≥ 0.20): ``splits[j]``
    rows of dim 0 go to rank j (by default ``dim 0 / size`` each); the
    output is what every rank sent here, concatenated in rank order.
    Uneven splits are negotiated through the engine first."""
    if isinstance(splits, str):
        raise TypeError(
            f"alltoall got a str for splits= ({splits!r}): the signature "
            "is alltoall(tensor, splits=None, name=None)")
    n = basics.size()
    if tensor.dim() == 0:
        raise ValueError("alltoall expects a tensor with >= 1 dim")
    if splits is None:
        if tensor.shape[0] % n:
            raise ValueError("alltoall expects each rank's dim 0 to be "
                             f"divisible by size={n}; got per-rank shape "
                             f"{tuple(tensor.shape)}")
        c = tensor.shape[0] // n
        S = [[c] * n for _ in range(n)]
        return _enqueue("alltoall", tensor, name, sizes=S)
    sp = splits.tolist() if hasattr(splits, "tolist") else list(splits)
    S = negotiate_alltoall_splits(sp, tensor.shape[0], name)
    return _enqueue("alltoall", tensor, name, sizes=S)


def alltoall(tensor: torch.Tensor, splits=None,
             name: str | None = None) -> torch.Tensor:
    return synchronize(alltoall_async(tensor, splits, name))


def barrier(name: str | None = None) -> None:
    """Returns once every rank entered it (``hvd.barrier``, Horovod ≥
    0.23): a one-element Sum allreduce through the engine, so that every
    eager op enqueued before it has been matched and dispatched too."""
    n = basics.size()
    out = synchronize(allreduce_async(
        torch.ones(1, device=basics.device()), op=Sum,
        name=name or _auto_name("barrier"),
        # A joined rank's zeros must not satisfy a rendezvous, and its
        # dispatch stays its own.
        no_fuse=True, join_identity=False))
    total = float(out[0])
    if total != float(n):
        raise HorovodInternalError(
            f"barrier saw contribution sum {total} != world size {n}")


def reducescatter_async(tensor: torch.Tensor, name: str | None = None, *,
                        op: _ReduceOp = Average) -> int:
    """Async reduce-scatter (``hvd.reducescatter``, Horovod ≥ 0.21): the
    ranks' tensors are averaged (Horovod's default) or summed and this
    rank keeps rows [r·d/n, (r+1)·d/n) of dim 0."""
    n = basics.size()
    if op not in (Sum, Average):
        raise ValueError(f"reducescatter supports Sum/Average, not {op}")
    if tensor.dim() == 0 or tensor.shape[0] % n:
        raise ValueError("reducescatter expects each rank's dim 0 to be "
                         f"divisible by size={n}; got per-rank shape "
                         f"{tuple(tensor.shape)}")
    return _enqueue("reducescatter", tensor, name, op=op)


def reducescatter(tensor: torch.Tensor, name: str | None = None, *,
                  op: _ReduceOp = Average) -> torch.Tensor:
    return synchronize(reducescatter_async(tensor, name, op=op))


def join() -> int:
    """``hvd.join()`` (Horovod ≥ 0.21); see :meth:`EagerEngine.join`."""
    return _engine().join()


def broadcast_async(tensor: torch.Tensor, root_rank: int,
                    name: str | None = None, *,
                    process_set: ProcessSet | None = None) -> int:
    """Async broadcast of ``root_rank``'s tensor (reference
    horovod/torch/mpi_ops.py:318-405); with a ``process_set`` (every rank
    calls it), members receive the root's value and the others keep
    their own."""
    eng = _engine()
    if not 0 <= root_rank < basics.size():
        raise ValueError(f"root_rank {root_rank} outside [0, {basics.size()})")
    if process_set is not None:
        if not process_set.included(root_rank):
            raise ValueError(
                f"broadcast root_rank {root_rank} is not in {process_set!r}")
        eng.ps_group(process_set)
    return _enqueue("broadcast", tensor, name, root_rank=root_rank,
                    process_set=process_set)


def broadcast(tensor: torch.Tensor, root_rank: int, name: str | None = None,
              *, process_set: ProcessSet | None = None) -> torch.Tensor:
    return synchronize(broadcast_async(tensor, root_rank, name,
                                       process_set=process_set))


def poll(handle: int) -> bool:
    """Non-blocking completion probe (reference torch/mpi_ops.py:406-419)."""
    eng = _engine()
    eng.flush()
    return eng.handles.poll(handle)


def engine_stats() -> dict:
    """A snapshot of the engine's counters: ``ops_enqueued``,
    ``batches_dispatched`` (one collective each), ``tensors_fused`` (ops
    that rode a multi-tensor bucket), ``allreduce_bytes`` (a rank's
    payload), ``errors`` (failed handles), ``stall_warnings``, and
    ``recent_negotiate_s`` (the last enqueue-to-dispatch waits).  Empty
    before the first eager op; not a barrier."""
    eng = basics._state.engine
    if eng is None:
        return {}
    out: dict = dict(eng.stats)
    out["recent_negotiate_s"] = list(eng.recent_negotiate_s)
    return out


def take_handle_post(handle: int):
    """Detach the handle's post payload; None if absent or released."""
    return _engine().handles.take_post(handle)


def update_handle_post(handle: int, **items) -> None:
    """Merge keys into a dict post payload, atomically."""
    _engine().handles.update_post(handle, items)


def release(handle: int) -> None:
    """Drop a handle without waiting (error-path cleanup).  No-op if
    already released."""
    _engine().handles.release(handle)


def synchronize(handle: int) -> torch.Tensor:
    """Wait until the op is dispatched and return its output; on the card
    the caller's stream waits on the collective, the host does not
    (reference torch/mpi_ops.py:422-438)."""
    eng = _engine()
    if eng.timeline is not None:
        tname = eng.handles.name(handle)
        if tname is not None:
            # Flush before opening the span, so that this tensor's own
            # negotiate and dispatch events come first.
            eng.flush()
            eng.timeline.async_start(tname, timeline_mod.WAIT_FOR_OUTPUT,
                                     handle)
            try:
                return eng.handles.wait(handle, lambda: None)
            finally:
                eng.timeline.async_end(tname, timeline_mod.WAIT_FOR_OUTPUT,
                                       handle)
    return eng.handles.wait(handle, eng.flush)


def grouped_allreduce_eager(tensors: Sequence[torch.Tensor],
                            average: bool | None = None,
                            names: list[str] | None = None, *,
                            op: _ReduceOp = Sum,
                            compression=Compression.none
                            ) -> list[torch.Tensor]:
    """Enqueue many allreduces in one call as one fusion group: its
    members enter the queue at once and, where fusion is planned locally,
    fuse only with each other, so the buckets are the same on every rank
    and every call (reference test/test_torch.py:175-224
    ``..._async_fused``)."""
    if names is not None and len(names) != len(tensors):
        raise ValueError(
            f"names has {len(names)} entries for {len(tensors)} tensors")
    gid = next(_group_counter)
    eng = None
    pendings = []
    for i, t in enumerate(tensors):
        eng, p = _prepare_allreduce(
            t, average, (names[i] if names else None), op=op,
            compression=compression, group_id=gid, process_set=None,
            no_fuse=False)
        pendings.append(p)
    if eng is not None:
        eng.enqueue_many(pendings)
    return [synchronize(p.handle) for p in pendings]

