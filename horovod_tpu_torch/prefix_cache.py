"""Shared-prefix KV cache: a radix index over ref-counted paged blocks.

Real serving fleets see the same system/few-shot prompt prefix on most
requests; recomputing its prefill per admission is the dominant
avoidable cost in the continuous-batching engine.  PagedAttention
(Kwon et al., vLLM SOSP '23) showed KV can be shared across requests at
block granularity; RadixAttention (Zheng et al., SGLang) showed an
automatic radix-tree index over token prefixes makes the sharing
transparent — no client-side prefix handles, just longest-prefix match
on admission.  This module is both, mapped onto the existing
:class:`~horovod_tpu_torch.models.llama.PagedKVCache` block tables:

* **Full, immutable blocks only.**  A physical block enters the index
  only once every one of its ``block_size`` positions holds the KV of a
  known token path starting at sequence position 0.  Indexed blocks are
  never written again — a row's write frontier is kept strictly inside
  its own private blocks (see COW below) — so sharing needs no device
  copies and no new compiled programs: a cache hit writes different
  block-table *data* through the engine's existing ``_set_row``
  program.

* **Radix tree keyed by token chunks.**  Each node is one full block;
  its edge key is the ``block_size``-token tuple the block holds, so a
  root-to-node path spells the exact token prefix (and therefore the
  exact rotary positions) the node's KV was computed from.  Longest
  prefix match walks the tree chunk by chunk; admission maps the hit
  blocks straight into the new slot's block-table row and chunked
  prefill starts at the first uncached token.

* **Reference counts + LRU release-to-cache.**  Every block a live row
  maps carries a reference (:class:`~horovod_tpu_torch.models.llama.BlockPool`);
  retirement *releases to cache* instead of freeing — zero-ref indexed
  blocks park in LRU order and are reclaimed leaf-first when admission
  runs short, always BEFORE any live decoding row is preempted.

* **Copy-on-write tail.**  The block containing a request's write
  frontier must be private.  A match is therefore capped at
  ``(len(prompt) - 1) // block_size`` blocks: at least the prompt's
  last token always re-prefills (its logits seed decoding — KV reuse
  alone can't produce them), and when the cap bites (prompt ends
  exactly on a block boundary, fully cached), the final shared block is
  "copied" by *recomputing* its tokens into a fresh private block —
  deterministic prefill makes the copy bit-identical, and the shared
  original is never touched.  Divergent continuations after a common
  prefix therefore never interfere: each row appends into its own tail.

The whole subsystem is host-side bookkeeping; parity is exact by
construction (same KV values at the same positions, same programs).  It
is the reference's ``horovod_tpu/prefix_cache.py`` over the port's
:class:`~horovod_tpu_torch.models.llama.BlockPool`, held against it by
``tests/test_torch_prefix_cache.py``.  Because it deals only in *logical*
block ids it is shard-agnostic, as the reference's tensor-parallel
engine relies on; the port serves on one card.
"""

from __future__ import annotations

import collections
import dataclasses
import hashlib
import sys
from typing import Iterable

from horovod_tpu_torch import metrics as metrics_mod
from horovod_tpu_torch.models.llama import BlockPool


def _update_chunk(h: "hashlib._Hash", chunk: Iterable[int]) -> None:
    """Fold one block-size token chunk into a running path digest.
    Token ids render as decimal bytes with unambiguous separators, so
    the encoding is stable across processes and Python versions (unlike
    the salted builtin ``hash``)."""
    h.update(b"|")
    for t in chunk:
        h.update(str(int(t)).encode())
        h.update(b",")


def chunk_path_digests(tokens: Iterable[int], block_size: int,
                       max_chunks: int | None = None) -> list[str]:
    """Digest every block-aligned prefix of ``tokens``.

    Entry ``i`` digests ``tokens[:(i + 1) * block_size]`` — exactly the
    token path a depth-``i + 1`` radix node spells — so membership of a
    prompt's digests in a cache's :meth:`RadixPrefixCache.key_digest`
    summary measures the longest indexed prefix WITHOUT shipping the
    tokens themselves.  Incremental blake2b keeps the whole list one
    pass over the prompt."""
    tokens = list(tokens)
    h = hashlib.blake2b(digest_size=8)
    n = len(tokens) // block_size
    if max_chunks is not None:
        n = min(n, max_chunks)
    out: list[str] = []
    for i in range(n):
        _update_chunk(h, tokens[i * block_size:(i + 1) * block_size])
        out.append(h.hexdigest())
    return out


@dataclasses.dataclass
class RadixNode:
    """One full, immutable KV block on the prefix tree.  ``key`` is the
    block's token chunk (the edge label from ``parent``); the
    root-to-here key concatenation is the token path whose KV the block
    holds at positions ``[depth * block_size, (depth+1) * block_size)``."""

    block: int
    key: tuple[int, ...]
    parent: "RadixNode | None"
    children: dict[tuple[int, ...], "RadixNode"] = dataclasses.field(
        default_factory=dict)


class RadixPrefixCache:
    """The prefix index over a :class:`BlockPool`.

    The cache never allocates: callers hand it blocks that are already
    written (``insert``), and it hands back shared blocks with a
    reference taken (``acquire``).  Eviction (``evict``) walks zero-ref
    LRU blocks leaf-first and returns them to the pool's free list;
    interior nodes become leaves as their children go, so a cold
    subtree drains oldest-leaf-first without ever orphaning a path.

    ``stats``: cumulative counters — ``hits`` (acquire calls matching
    >= 1 block), ``misses``, ``blocks_reused``, ``tokens_skipped``
    (``blocks_reused * block_size``: prefill positions admission did
    not recompute), ``inserted_blocks``, ``evicted_blocks``.  Each is
    mirrored into ``metrics`` as a ``prefix.<name>`` counter
    (:mod:`horovod_tpu_torch.metrics`); the default ``NULL`` registry makes a
    standalone cache silent, while :class:`ServeEngine` passes its own
    registry so the mirrors land in the engine's scrape.
    """

    def __init__(self, pool: BlockPool, block_size: int,
                 metrics: "metrics_mod.MetricsRegistry | None" = None):
        if block_size < 1:
            raise ValueError(f"block_size {block_size} must be >= 1")
        self.pool = pool
        self.block_size = block_size
        self.metrics = metrics if metrics is not None else metrics_mod.NULL
        self._root = RadixNode(block=0, key=(), parent=None)
        self._nodes: dict[int, RadixNode] = {}     # block -> node
        self.stats = {"hits": 0, "misses": 0, "blocks_reused": 0,
                      "tokens_skipped": 0, "inserted_blocks": 0,
                      "evicted_blocks": 0}
        self._digest_cache: dict | None = None

    def _bump(self, key: str, n: int = 1) -> None:
        self.stats[key] += n
        self.metrics.counter("prefix." + key).inc(n)

    # -- introspection -----------------------------------------------------

    def indexed_blocks(self) -> int:
        return len(self._nodes)

    def approx_footprint_bytes(self) -> int:
        """Approximate host bytes the radix index holds (the
        ``mem.prefix_index_bytes`` gauge): per node its object, its
        token-chunk key tuple, and its children dict, plus the block->
        node map — shallow ``sys.getsizeof`` sums, a leak-spotting
        trend line rather than an exact audit."""
        total = sys.getsizeof(self._nodes)
        for node in [self._root, *self._nodes.values()]:
            total += (sys.getsizeof(node) + sys.getsizeof(node.key)
                      + sys.getsizeof(node.children))
        return total

    def key_digest(self, max_paths: int = 256) -> dict:
        """Bounded summary of the index for cache-aware routing.

        Returns ``{"block_size", "indexed_blocks", "n_paths",
        "truncated", "paths"}`` where ``paths`` holds up to
        ``max_paths`` hex digests of root-to-node token paths
        (:func:`chunk_path_digests` encoding), breadth-first — shallow
        prefixes (the system prompts a router cares about) always make
        the cut; deep divergent tails are what truncation drops.  A
        router matches a prompt by digesting its own chunks and finding
        the deepest digest present here; no token ever leaves the
        replica.  Cost is one ``blake2b.copy()`` + one chunk hash per
        emitted path, so the summary is cheap enough to ride every
        ``metrics_snapshot()``.

        The monitor serves ``/snapshot`` from its own HTTP thread while
        the engine thread inserts/evicts nodes, so a scrape can land
        mid-mutation and the walk can see a ``children`` dict change
        size under it.  The walk retries on that ``RuntimeError`` and,
        if the tree never holds still, falls back to the last complete
        summary — staleness is benign for routing (one suboptimal
        placement), a crashed scrape is not."""
        for _ in range(4):
            try:
                summary = self._key_digest_walk(max_paths)
            except RuntimeError:        # tree mutated mid-walk
                continue
            self._digest_cache = summary
            return summary
        stale = self._digest_cache
        if stale is not None:
            return dict(stale)
        return {"block_size": self.block_size,
                "indexed_blocks": len(self._nodes), "n_paths": 0,
                "truncated": len(self._nodes) > 0, "paths": []}

    def _key_digest_walk(self, max_paths: int) -> dict:
        paths: list[str] = []
        base = hashlib.blake2b(digest_size=8)
        q: "collections.deque[tuple[RadixNode, hashlib._Hash]]" = \
            collections.deque(
                (child, base) for child in self._root.children.values())
        while q and len(paths) < max_paths:
            node, parent_h = q.popleft()
            h = parent_h.copy()
            _update_chunk(h, node.key)
            paths.append(h.hexdigest())
            for c in node.children.values():
                q.append((c, h))
        return {
            "block_size": self.block_size,
            "indexed_blocks": len(self._nodes),
            "n_paths": len(paths),
            "truncated": len(self._nodes) > len(paths),
            "paths": paths,
        }

    def __contains__(self, block: int) -> bool:
        return block in self._nodes

    def path_blocks(self, tokens: list[int]) -> list[int]:
        """Longest-prefix match WITHOUT taking references (read-only
        peek, for tests/dumps): block ids covering the longest fully
        indexed chunk path of ``tokens``."""
        return [n.block for n in self._walk(tokens, len(tokens))]

    # -- the hit path ------------------------------------------------------

    def _walk(self, tokens: list[int], max_tokens: int) -> list[RadixNode]:
        bs = self.block_size
        node, out = self._root, []
        for i in range(min(len(tokens), max_tokens) // bs):
            child = node.children.get(tuple(tokens[i * bs:(i + 1) * bs]))
            if child is None:
                break
            out.append(child)
            node = child
        return out

    def acquire(self, tokens: list[int]) -> list[int]:
        """Longest-prefix match for an admission, references taken.

        Returns the physical blocks covering the longest indexed chunk
        path of ``tokens[:-1]`` — capped one token short so the block
        holding the write frontier is always private (the COW rule: a
        full hit recomputes its final chunk into a fresh block rather
        than mutating the shared one).  Each returned block is
        incref'd — pinned against eviction — until ``release``."""
        matched = self._walk(tokens, max(len(tokens) - 1, 0))
        blocks = [n.block for n in matched]
        for b in blocks:
            self.pool.incref(b)
        if blocks:
            self._bump("hits")
            self._bump("blocks_reused", len(blocks))
            self._bump("tokens_skipped", len(blocks) * self.block_size)
        else:
            self._bump("misses")
        return blocks

    def release(self, blocks: Iterable[int]) -> None:
        """Drop one reference per block (row retirement / requeue /
        failed admission).  Indexed blocks reaching zero references
        park in the pool's LRU cache; private ones free."""
        for b in blocks:
            self.pool.decref(b)

    # -- the insert path ---------------------------------------------------

    def insert(self, tokens: list[int], blocks: list[int],
               frontier: int) -> int:
        """Register a retiring row's full blocks (release-to-cache).

        ``tokens`` is the row's complete token path from position 0
        (replay prompt + emitted output), ``blocks`` its physical
        blocks in table order, ``frontier`` how many positions of the
        path are actually written (<= len(tokens)).  Every fully
        written block extends the tree; a chunk path that already has a
        node keeps the incumbent block (the retiring row's duplicate
        stays unindexed and frees on release).  Returns how many blocks
        were newly indexed.  The caller still owns its references —
        call ``release`` afterwards."""
        bs = self.block_size
        node, added = self._root, 0
        for i in range(min(frontier, len(tokens)) // bs):
            key = tuple(tokens[i * bs:(i + 1) * bs])
            child = node.children.get(key)
            if child is None:
                child = RadixNode(block=blocks[i], key=key, parent=node)
                node.children[key] = child
                self._nodes[blocks[i]] = child
                self.pool.mark_indexed(blocks[i])
                added += 1
            node = child
        if added:
            self._bump("inserted_blocks", added)
        return added

    # -- eviction ----------------------------------------------------------

    def evict(self, n_blocks: int) -> int:
        """Free up to ``n_blocks`` cached blocks, LRU leaf-first.

        Only zero-reference leaves are evictable (an interior node's
        block must outlive its descendants or their paths would dangle;
        a referenced block is pinned by live rows).  Evicting a leaf
        can turn its parent into a leaf, so the walk repeats until the
        quota is met or a full pass frees nothing.  Returns the number
        of blocks returned to the free list."""
        freed = 0
        while freed < n_blocks:
            progress = False
            for b in self.pool.lru_blocks():          # oldest first
                node = self._nodes[b]
                if node.children:
                    continue                          # interior: skip
                del node.parent.children[node.key]
                del self._nodes[b]
                self.pool.drop_indexed(b)             # -> free list
                freed += 1
                progress = True
                if freed >= n_blocks:
                    break
            if not progress:
                break
        if freed:
            self._bump("evicted_blocks", freed)
            self.metrics.event("prefix.evict", freed=freed,
                               indexed=len(self._nodes))
        return freed

    # -- debugging ---------------------------------------------------------

    def check_consistency(self) -> None:
        """Structural invariants (the env-gated debug walk): every
        indexed block has a tree node reachable from the root, parents
        of every node are indexed (no dangling paths), and zero-ref
        indexed blocks are exactly the pool's LRU set."""
        seen: dict[int, RadixNode] = {}
        stack = list(self._root.children.values())
        while stack:
            n = stack.pop()
            if n.block in seen:
                raise AssertionError(
                    f"block {n.block} appears at two tree positions")
            seen[n.block] = n
            stack.extend(n.children.values())
        if seen.keys() != self._nodes.keys():
            raise AssertionError(
                f"node map out of sync with tree: map-only="
                f"{set(self._nodes) - set(seen)} tree-only="
                f"{set(seen) - set(self._nodes)}")
        lru = set(self.pool.lru_blocks())
        zero_ref = {b for b in seen if self.pool.refcount(b) == 0}
        if lru != zero_ref:
            raise AssertionError(
                f"LRU set {lru} != zero-ref indexed set {zero_ref}")
