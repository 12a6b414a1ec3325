"""Async-handle bookkeeping for the eager engine.

Port of ``horovod_tpu/ops/handle_manager.py`` (the reference's
``HandleManager``, horovod/torch/handle_manager.h/.cc:22-53): int handles
mapped to results, behind ``poll()`` and ``synchronize()``.  A handle
moves through three states:

  QUEUED      enqueued, waiting for the engine's cycle to fuse and dispatch it
  DISPATCHED  its collective was issued: the result holds the NCCL/gloo
              ``Work`` and, on the card, a CUDA event recorded after it
  DONE        the caller's stream waits on it (or an error was captured)

A dispatched result is any object; if it has ``is_ready()``, ``poll``
asks it, and if it has ``value()``, ``wait`` returns what that gives
(the engine's ``_Output``: the Work's completion or the event's query, and
the caller's stream made to wait on the collective before it reads).
"""

from __future__ import annotations

import itertools
import threading
from dataclasses import dataclass, field
from typing import Any


@dataclass
class _Entry:
    event: threading.Event = field(default_factory=threading.Event)
    result: Any = None
    error: BaseException | None = None
    dispatched: bool = False
    name: str | None = None      # tensor name, for timeline attribution
    post: Any = None             # frontend post-processing payload (opaque)


class HandleManager:
    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._counter = itertools.count()
        self._entries: dict[int, _Entry] = {}

    def allocate(self, name: str | None = None) -> int:
        h = next(self._counter)
        with self._lock:
            self._entries[h] = _Entry(name=name)
        return h

    def name(self, handle: int) -> str | None:
        with self._lock:
            e = self._entries.get(handle)
            return e.name if e is not None else None

    def set_post(self, handle: int, payload: Any) -> None:
        """Attach a frontend post-processing payload to a live handle; it
        lives and dies with the entry (released by ``wait``, ``release``
        and the error paths alike)."""
        with self._lock:
            e = self._entries.get(handle)
            if e is not None:
                e.post = payload

    def update_post(self, handle: int, items: dict) -> None:
        """Merge keys into a dict-valued post payload, one atomic
        read-modify-write under the manager lock."""
        with self._lock:
            e = self._entries.get(handle)
            if e is None:
                return
            if not isinstance(e.post, dict):
                e.post = {}
            e.post.update(items)

    def take_post(self, handle: int) -> Any:
        """Detach and return the handle's post payload (None if absent)."""
        with self._lock:
            e = self._entries.get(handle)
            if e is None:
                return None
            payload, e.post = e.post, None
            return payload

    def _get(self, handle: int) -> _Entry:
        with self._lock:
            try:
                return self._entries[handle]
            except KeyError:
                raise ValueError(
                    f"handle {handle} is unknown or already released"
                ) from None

    def mark_dispatched(self, handle: int, result: Any) -> None:
        # A released handle is tolerated: an error-path release() can drop
        # a handle whose op is still queued, and its dispatch must not fail
        # mid-batch (which would leave fused peers unmarked).
        with self._lock:
            e = self._entries.get(handle)
        if e is None:
            return
        e.result = result
        e.dispatched = True
        e.event.set()

    def mark_error(self, handle: int, err: BaseException) -> None:
        with self._lock:
            e = self._entries.get(handle)
        if e is None:
            return
        e.error = err
        e.dispatched = True
        e.event.set()

    def poll(self, handle: int) -> bool:
        """Non-blocking readiness check (reference handle_manager.cc:35-39
        and the ``cudaEventQuery`` of ready_event.cc:34-92)."""
        e = self._get(handle)
        if not e.event.is_set():
            return False
        if e.error is not None:
            return True
        r = e.result
        if hasattr(r, "is_ready"):
            return bool(r.is_ready())
        return True

    def wait(self, handle: int, flush) -> Any:
        """Block until dispatched, release the handle, return the result.
        ``flush`` runs first so that queued work cannot deadlock."""
        flush()
        e = self._get(handle)
        e.event.wait()
        try:
            if e.error is not None:
                raise e.error
            result = e.result
            if hasattr(result, "value"):
                return result.value()
            return result
        finally:
            self.release(handle)

    def release(self, handle: int) -> None:
        with self._lock:
            self._entries.pop(handle, None)

    def outstanding(self) -> int:
        with self._lock:
            return len(self._entries)
