"""Continuous-batching serving loop for the port's Llama inference core.

Port of ``horovod_tpu/serving.py`` (``Request`` through
``ContinuousBatcher``), built from the ragged KV-cache primitives of
:mod:`horovod_tpu_torch.models.llama`:

* a fixed pool of **slots** (the batch dimension of the decode tick);
* **admission** of a request into a free slot mid-stream: a B=1 chunked
  prefill at ``admit_width`` whose K/V window is spliced into the pool
  cache at the slot row (optionally continuing from a shared
  :class:`PrefixCache`);
* a **decode tick** advancing every slot one token, with per-row cache
  positions and masks keeping the rows independent;
* host-side orchestration only at the boundaries.

The reference counts its compiled programs (``compile_cache_sizes``); the
port runs eagerly and has no such counter.  ``speculative_generate`` comes
with the serving-engine slice.
"""

from __future__ import annotations

import dataclasses
from typing import Any

import torch

from horovod_tpu_torch.models import llama
from horovod_tpu_torch.models.llama import KVCache


@dataclasses.dataclass
class Request:
    """One generation request: prompt token ids + a new-token budget.

    ``sample_key``: a ``torch.Generator`` (on the serving device) or an int
    seed, for sampled decoding; required when the effective temperature is
    > 0.  The slot draws each token from it exactly as solo
    ``generate(key=...)`` does, one [1, V] draw per token.

    ``prefix``: a :class:`PrefixCache` this request continues from;
    ``prompt`` is then just the suffix.  ``temperature``: per-request
    override of the pool temperature (``None`` inherits it).

    ``deadline_s``, ``max_queue_steps``, ``slo_s``, ``priority`` and
    ``trace_ctx`` are the reference's serving-engine lifecycle fields; they
    are kept for that engine's port and :class:`ContinuousBatcher` ignores
    them."""

    prompt: list[int]
    max_new_tokens: int
    eos_id: int | None = None
    sample_key: Any = None
    prefix: "PrefixCache | None" = None
    temperature: float | None = None
    deadline_s: float | None = None
    max_queue_steps: int | None = None
    slo_s: float | None = None
    priority: int = 0
    trace_ctx: Any = None


# Terminal request statuses (serving-engine request lifecycle).
OK = "OK"
TIMEOUT = "TIMEOUT"
CANCELLED = "CANCELLED"
FAILED = "FAILED"
REJECTED = "REJECTED"


class RequestResult(list):
    """Terminal result of one engine request: the emitted tokens plus a
    lifecycle status.  Subclasses ``list`` so consumers of plain token
    lists keep working; non-``OK`` results carry tokens-so-far."""

    def __init__(self, tokens=(), status: str = OK,
                 error: BaseException | None = None, trace: Any = None):
        super().__init__(tokens)
        self.status = status
        self.error = error
        self.trace = trace

    @property
    def tokens(self) -> list[int]:
        return list(self)

    @property
    def ok(self) -> bool:
        return self.status == OK

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        err = f", error={self.error!r}" if self.error is not None else ""
        return (f"RequestResult(status={self.status}, "
                f"tokens={list(self)}{err})")


class PrefixCache:
    """Precomputed K/V of a shared prompt prefix (the system-prompt
    pattern): prefill once, splice into every admission that carries it.

    Storage: [n_layers, 1, P_pad, KVH, Dh] K/V plus the true token count.
    """

    def __init__(self, k: torch.Tensor, v: torch.Tensor, length: int):
        self.k, self.v, self.length = k, v, int(length)


def precompute_prefix(params: dict, cfg: llama.LlamaConfig,
                      tokens: list[int], *,
                      window: int | None = None) -> PrefixCache:
    """Prefill a shared prefix once → a splice-ready :class:`PrefixCache`.

    ``window=None`` runs one :func:`llama.prefill` (with
    ``attn_impl="flash"``, through the flash kernel); a ``window`` chunks
    it through ``llama.prefill_chunked`` and pads the buffer to a window
    multiple (``length`` stays the true token count).
    """
    if not tokens:
        raise ValueError("empty prefix")
    dev = params["embed"].device
    p = len(tokens)
    if window is None:
        t = torch.as_tensor([tokens], dtype=torch.int64, device=dev)
        cache = llama.init_cache(cfg, 1, p, device=dev)
        _, cache = llama.prefill(params, t, cfg, cache)
        return PrefixCache(cache.k, cache.v, p)
    pad = -(-p // window) * window
    t = torch.zeros((1, pad), dtype=torch.int64, device=dev)
    t[0, :p] = torch.as_tensor(tokens, dtype=torch.int64)
    cache = llama.init_cache(cfg, 1, pad, device=dev)
    cache = cache._replace(length=torch.zeros((1,), dtype=torch.int64,
                                              device=dev))
    _, cache = llama.prefill_chunked(
        params, t, cfg, cache, window=window,
        lengths=torch.tensor([p], dtype=torch.int64, device=dev))
    return PrefixCache(cache.k, cache.v, p)


def _splice(cache: KVCache, k_new: torch.Tensor, v_new: torch.Tensor,
            slot: int, length: int) -> KVCache:
    """Write a B=1 prefill's K/V window into slot ``slot`` of the pool, in
    place.  k_new/v_new: [n_layers, 1, W, KVH, Dh].  Only the first W
    positions of the slot row are written; ``length`` is the row's true
    prompt length, and positions beyond it are unreadable until rewritten
    (write-before-read)."""
    w = k_new.shape[2]
    cache.k[:, slot, :w] = k_new[:, 0]
    cache.v[:, slot, :w] = v_new[:, 0]
    cache.length[slot] = length
    return cache


class ContinuousBatcher:
    """Serve mixed-length requests through a fixed slot pool.

    ``n_slots`` is the decode batch; ``max_len`` bounds prefix + prompt +
    generation per request; ``admit_width`` is the admission window
    (prompts chunk in at this width).  ``temperature``/``top_k``/``top_p``
    are pool-level sampling knobs; a request may override the temperature.
    The pool lives on the parameters' device.
    """

    def __init__(self, params: dict, cfg: llama.LlamaConfig, *,
                 n_slots: int, max_len: int, admit_width: int,
                 temperature: float = 0.0, top_k: int | None = None,
                 top_p: float | None = None):
        if admit_width > max_len:
            raise ValueError(
                f"admit_width {admit_width} > max_len {max_len}: the "
                f"admission window must fit inside the pool cache")
        self.params = params
        self.cfg = cfg
        self.device = params["embed"].device
        self.n_slots = n_slots
        self.max_len = max_len
        self.admit_width = admit_width
        self.temperature = float(temperature)
        self.top_k, self.top_p = top_k, top_p
        cache = llama.init_cache(cfg, n_slots, max_len, device=self.device)
        # ragged from birth: every row owns its position
        self.cache = cache._replace(length=torch.zeros(
            (n_slots,), dtype=torch.int64, device=self.device))
        self.last_logits = torch.zeros((n_slots, cfg.vocab_size),
                                       dtype=torch.float32, device=self.device)
        # host-side slot state
        self._busy = [False] * n_slots
        self._budget = [0] * n_slots
        self._eos: list[int | None] = [None] * n_slots
        self._out: list[list[int]] = [[] for _ in range(n_slots)]
        self._gens: list[torch.Generator | None] = [None] * n_slots
        self._temps = [0.0] * n_slots

    # -- admission ---------------------------------------------------------

    def free_slots(self) -> list[int]:
        return [i for i, b in enumerate(self._busy) if not b]

    def _prefill_row(self, prefix: "PrefixCache | None", tokens, length):
        # Chunked at the admission width.  The B=1 cache holds the prefix
        # K/V (if any) at [0, P_pad) and the padded prompt after it, so
        # the splice moves only the K/V this admission made; the prompt
        # chunk-prefills from the prefix's true length P.
        p_pad = prefix.k.shape[2] if prefix is not None else 0
        cache = llama.init_cache(self.cfg, 1, p_pad + tokens.shape[1],
                                 device=self.device)
        if prefix is not None:
            cache.k[:, :, :p_pad] = prefix.k
            cache.v[:, :, :p_pad] = prefix.v
        cache = cache._replace(length=torch.tensor(
            [prefix.length if prefix is not None else 0], dtype=torch.int64,
            device=self.device))
        logits, cache = llama.prefill_chunked(
            self.params, tokens, self.cfg, cache, window=self.admit_width,
            lengths=length)
        return logits[0], cache.k, cache.v

    def admit(self, req: Request) -> int:
        """Prefill ``req`` into a free slot (chunked at ``admit_width``);
        returns the slot index."""
        L = len(req.prompt)
        if L < 1:
            raise ValueError("empty prompt")
        if req.max_new_tokens < 1:
            raise ValueError("max_new_tokens must be >= 1")
        eff_temp = (self.temperature if req.temperature is None
                    else float(req.temperature))
        # validated BEFORE any state changes: a rejected admission must
        # not leave the slot busy or spliced
        if eff_temp > 0.0 and self.temperature <= 0.0:
            raise ValueError(
                "a greedy pool runs no sampling tick; construct the "
                "ContinuousBatcher with temperature > 0 to serve sampled "
                "requests (per-request temperature can still be 0)")
        if eff_temp > 0.0 and req.sample_key is None:
            raise ValueError(
                "sampled request (temperature > 0) needs a sample_key")
        P = req.prefix.length if req.prefix is not None else 0
        p_pad = int(req.prefix.k.shape[2]) if req.prefix is not None else 0
        if P + L + req.max_new_tokens > self.max_len:
            raise ValueError(
                f"prefix {P} + prompt {L} + max_new_tokens "
                f"{req.max_new_tokens} exceeds max_len {self.max_len}")
        w = self.admit_width
        n_win = -(-L // w)
        if p_pad + n_win * w > self.max_len:
            raise ValueError(
                f"prefix buffer {p_pad} + prompt {L} padded to "
                f"{n_win * w} admission windows exceeds max_len "
                f"{self.max_len}")
        free = self.free_slots()
        if not free:
            raise RuntimeError("no free slot; call step() until one opens")
        slot = free[0]
        padded = torch.zeros((1, n_win * w), dtype=torch.int64)
        padded[0, :L] = torch.as_tensor(req.prompt, dtype=torch.int64)
        padded = padded.to(self.device)
        length = torch.tensor([L], dtype=torch.int64, device=self.device)
        logits, k_new, v_new = self._prefill_row(req.prefix, padded, length)
        self.cache = _splice(self.cache, k_new, v_new, slot, P + L)
        self.last_logits[slot] = logits
        self._busy[slot] = True
        self._budget[slot] = req.max_new_tokens
        self._eos[slot] = req.eos_id
        self._out[slot] = []
        self._temps[slot] = eff_temp
        self._gens[slot] = (llama.as_generator(req.sample_key, self.device)
                            if eff_temp > 0.0 else None)
        return slot

    # -- decode ------------------------------------------------------------

    def _pick(self) -> torch.Tensor:
        tok = torch.argmax(self.last_logits, dim=-1)
        for s in range(self.n_slots):
            t = self._temps[s]
            if self._busy[s] and t > 0.0:
                # the row's own [1, V] draw, as solo generate makes it
                tok[s] = llama.sample_logits(
                    self.last_logits[s:s + 1], self._gens[s], temperature=t,
                    top_k=self.top_k, top_p=self.top_p)[0]
        return tok

    def step(self) -> dict[int, list[int]]:
        """Advance every slot one token; returns {slot: tokens} for
        requests that finished on this tick."""
        tok = self._pick()
        self.last_logits, self.cache = llama.decode_step(
            self.params, tok, self.cfg, self.cache)
        done: dict[int, list[int]] = {}
        tok_host = tok.tolist()
        for slot in range(self.n_slots):
            if not self._busy[slot]:
                continue
            t = int(tok_host[slot])
            self._out[slot].append(t)
            self._budget[slot] -= 1
            if self._budget[slot] <= 0 or t == self._eos[slot]:
                done[slot] = self._out[slot]
                self._busy[slot] = False
        # Free rows tick with the batch and write garbage K/V at their own
        # position, which is safe because every occupant writes a position
        # before attending to it.  The reference rewinds a row to 0 when it
        # retires and drops writes that run past max_len; the port rewinds
        # every free row each tick instead, so its writes stay in bounds.
        free = self.free_slots()
        if free:
            self.cache.length[free] = 0
        return done

    # -- convenience -------------------------------------------------------

    def run(self, requests: list[Request]) -> list[list[int]]:
        """Serve ``requests`` to completion (admission order, slots
        recycled as they free up); returns each request's tokens."""
        results: list[list[int] | None] = [None] * len(requests)
        slot_owner: dict[int, int] = {}
        pending = list(enumerate(requests))
        while pending or slot_owner:
            while pending and self.free_slots():
                idx, req = pending.pop(0)
                slot_owner[self.admit(req)] = idx
            for slot, toks in self.step().items():
                results[slot_owner.pop(slot)] = toks
        assert all(r is not None for r in results)
        return results  # type: ignore[return-value]
