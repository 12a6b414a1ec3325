"""Prompt-lookup drafting: free draft tokens for speculative decode.

A copy of ``horovod_tpu/drafting.py`` for the PyTorch port, which may not
import the JAX package (its ``__init__`` pulls in jax); environment
knobs are ``HVD_TORCH_*`` here.  Names of modules the port does not
have yet (the router, the monitor, tracing, ...) are the reference's.

Speculative decoding needs a proposal source; the classic recipe
(Leviathan et al. 2023) runs a second, smaller model.  Prompt-lookup
decoding (Saxena 2023; merged into HF transformers as
``prompt_lookup_num_tokens``) observes that for grounded workloads —
summarization, code edit, multi-turn chat, RAG — the continuation is
usually *already in the context*: find the most recent earlier
occurrence of the current suffix n-gram in the request's own
prompt+output history and propose the tokens that followed it.  No
draft model, no extra forward pass, no new device programs — the
drafter is pure host-side stdlib, and greedy longest-prefix acceptance
makes a bad proposal merely useless, never wrong (see
:func:`horovod_tpu_torch.models.llama.spec_verify_paged`).

:class:`NgramDraftState` is the per-request object
:class:`~horovod_tpu_torch.serving_scheduler.ServeEngine` hangs off each slot
when ``spec=True``: an **incremental** n-gram index (O(max_ngram) dict
updates per emitted token, O(max_ngram) lookups per proposal) so a
long-running row never rescans its history.

One alignment subtlety, documented here because it shapes
:meth:`NgramDraftState.propose`: the engine drafts *before* the tick
that emits the next token, so the token the drafts must continue
(``tok``, the argmax of the row's last logits) is still on device.  The
lookup therefore matches the suffix ending at the last *emitted* token;
the matched continuation's first element is the history's guess for
``tok`` itself and is **skipped** — the proposal starts one past it.
When the guess is right (the repeating case the drafter exists for) the
drafts align perfectly; when it is wrong they are rejected at position
0 by the verify program, which costs nothing beyond the already-fixed
``(draft_k + 1)``-wide tick.
"""

from __future__ import annotations

from typing import Iterable

#: Engine default for ``draft_k`` (the ``HVD_TORCH_DRAFT_K`` knob).
DEFAULT_DRAFT_K = 4


class NgramDraftState:
    """Incremental n-gram lookup over one request's token history.

    ``tokens`` seeds the history (the engine passes prompt + replayed
    prior tokens); :meth:`extend` appends emitted tokens as they land.
    For each n in ``[min_ngram, max_ngram]`` the index maps every seen
    n-gram to the END positions (exclusive) of its two most recent
    occurrences plus its first — the two most recent because the
    current suffix is always its own latest occurrence and a proposal
    needs the one before it; the first as a fallback for short-period
    streams (e.g. a model stuck on one token), where *every* recent
    occurrence butts up against the end of the history and has no
    continuation left to propose from.
    """

    __slots__ = ("min_ngram", "max_ngram", "toks", "_index")

    def __init__(self, tokens: Iterable[int], *, max_ngram: int = 3,
                 min_ngram: int = 1):
        if min_ngram < 1 or max_ngram < min_ngram:
            raise ValueError(
                f"need 1 <= min_ngram <= max_ngram, got "
                f"[{min_ngram}, {max_ngram}]")
        self.min_ngram = min_ngram
        self.max_ngram = max_ngram
        self.toks: list[int] = []
        # one dict per n: gram -> (last_end, prev_end | None, first_end)
        self._index: list[dict[tuple[int, ...],
                               tuple[int, int | None, int]]] = [
            {} for _ in range(max_ngram - min_ngram + 1)]
        self.extend(tokens)

    def extend(self, tokens: Iterable[int]) -> None:
        """Append emitted tokens, updating the index incrementally."""
        for t in tokens:
            self.toks.append(int(t))
            i = len(self.toks)
            for n in range(self.min_ngram, self.max_ngram + 1):
                if i < n:
                    break
                d = self._index[n - self.min_ngram]
                gram = tuple(self.toks[i - n:i])
                prev = d.get(gram)
                d[gram] = ((i, prev[0], prev[2]) if prev is not None
                           else (i, None, i))

    def propose(self, k: int) -> list[int]:
        """Up to ``k`` draft tokens continuing the (still unknown)
        in-flight token, longest-n match first; ``[]`` when the history
        holds no earlier occurrence of any suffix n-gram (the verify
        tick then degrades to a plain decode for this row)."""
        L = len(self.toks)
        if k < 1:
            return []
        for n in range(min(self.max_ngram, L), self.min_ngram - 1, -1):
            ends = self._index[n - self.min_ngram].get(
                tuple(self.toks[L - n:]))
            if ends is None:
                continue
            # the suffix is always its own latest occurrence (last == L);
            # the previous one is the preferred (most recent) source of
            # the continuation, the first occurrence the fallback when
            # the previous one sits at the end of a short-period run
            # and has nothing after it
            recent = ends[1] if ends[0] == L else ends[0]
            for src in (recent, ends[2]):
                if src is None or src == L:
                    continue
                # toks[src] is the history's guess for the in-flight
                # token — skipped (see module docstring); drafts start
                # one past it
                cont = self.toks[src + 1:src + 1 + k]
                if cont:
                    return list(cont)
        return []
