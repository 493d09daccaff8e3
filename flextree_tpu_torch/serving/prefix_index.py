"""Radix index over prompt token ids: cross-request prefix-cache lookup.

The port's own copy of ``flextree_tpu/serving/prefix_index.py`` (host-only
code; the port imports nothing of the JAX package).

Millions of requests share system prompts and few-shot preambles; the
paged pool (``kv_cache``) makes the K/V of a shared prefix reusable
because a block's bytes are a pure function of the token prefix that
produced them (RoPE positions are absolute, the causal mask zeroes
everything else — the same argument that makes paged decode bitwise
against ``generate``).  This module is the lookup structure:

- a **radix trie at block granularity**: each edge is the tuple of
  exactly ``block_size`` token ids a FULL block was computed from, each
  node owns that block id.  Only full blocks are cacheable — a partial
  tail block receives decode writes and is always private to its
  sequence, so it never enters the index.
- **refcounted adoption**: ``insert`` (called at retirement with the
  sequence's full PROMPT blocks — never the decode-polluted tail)
  retains each block it adopts; ``match`` returns the longest chain of
  cached blocks for a prompt, and the batcher retains the ones it
  shares.  A block leaves the pool's free list exactly while someone —
  index or sequence — holds it.
- **LRU eviction under pool pressure**: when admission cannot allocate,
  the batcher asks the index to give blocks back.  Only entries with no
  live sequence holder (allocator refcount 1 — the index's own
  reference) are evictable, leaves first (evicting an interior node
  would orphan reachable children), least-recently-matched first.
- **deterministic keying**: keys are token-id tuples, the LRU clock is a
  logical counter, and ties break on node creation order — two replicas
  fed the same request sequence build bit-identical tries, which is what
  makes prefix-affinity routing at the front door worth anything.

Invariant violations (double-indexed block, wrong key width, foreign
block) raise :class:`PrefixIndexError` loudly — a silently corrupted
index would hand one sequence another prompt's K/V.
"""

from __future__ import annotations

from .kv_cache import BlockAllocator

__all__ = ["PrefixIndexError", "PrefixIndex"]


class PrefixIndexError(RuntimeError):
    """An index invariant broke — stable-code'd like the other loud
    serving failures."""

    code = "FT_PREFIX_INDEX"

    def __init__(self, msg: str):
        super().__init__(f"{self.code}: {msg}")


class _Node:
    __slots__ = ("key", "block", "children", "last_used", "seq")

    def __init__(self, key: tuple, block: int, seq: int):
        self.key = key
        self.block = block
        self.children: dict = {}
        self.last_used = seq
        self.seq = seq  # creation order: the deterministic LRU tie-break


class PrefixIndex:
    """Block-granularity radix trie over prompt token ids.

    The allocator is taken at construction so retain/release stay next
    to the structural mutation they justify — an index entry without its
    allocator reference (or vice versa) is exactly the leak/corruption
    pair the churn test hunts."""

    def __init__(self, block_size: int, allocator: BlockAllocator):
        if block_size < 1:
            raise ValueError("block_size must be >= 1")
        self.block_size = int(block_size)
        self.allocator = allocator
        self._children: dict = {}  # root level: key tuple -> _Node
        self._blocks: set[int] = set()  # every indexed block, for loudness
        self._clock = 0
        # accounting the engine exports (counters, not gauges: the index
        # is single-threaded under the engine loop)
        self.lookups = 0
        self.hit_blocks = 0
        self.inserted = 0
        self.evictions = 0
        self.on_evict = None  # optional hook(block_id) for events/metrics

    # ---- internals ---------------------------------------------------------

    def _tick(self) -> int:
        self._clock += 1
        return self._clock

    @staticmethod
    def _key(tokens, j: int, bs: int) -> tuple:
        return tuple(int(t) for t in tokens[j * bs : (j + 1) * bs])

    @property
    def size(self) -> int:
        return len(self._blocks)

    # ---- lookup ------------------------------------------------------------

    def match(self, tokens) -> list:
        """Longest chain of cached FULL blocks prefixing ``tokens``.

        Returns the block ids in prefix order (possibly empty).  At most
        ``len(tokens) // block_size`` blocks match — the partial tail is
        never cached; the ADMISSION layer further decides how many of the
        matched blocks it can share outright and whether the last one
        needs a copy-on-write fork (a full-prompt hit still must run the
        final token through the model for its logits).  Touches the LRU
        clock along the matched path."""
        bs = self.block_size
        limit = len(tokens) // bs
        self.lookups += 1
        out: list = []
        children = self._children
        now = self._tick()
        for j in range(limit):
            node = children.get(self._key(tokens, j, bs))
            if node is None:
                break
            node.last_used = now
            out.append(node.block)
            children = node.children
        self.hit_blocks += len(out)
        return out

    # ---- insertion (at retirement) -----------------------------------------

    def insert(self, tokens, block_ids) -> int:
        """Adopt a retired sequence's full PROMPT blocks into the trie.

        ``block_ids`` must cover ``len(block_ids) * block_size`` leading
        tokens of ``tokens`` with FULL blocks — the caller passes
        ``block_ids[: prompt_len // block_size]``, never the tail block
        decode wrote into.  A chain node that already exists keeps its
        existing block (first writer wins; both hold bitwise-identical
        bytes, so preferring the resident one avoids a pointless retain/
        release churn).  Newly adopted blocks are retained — the index
        becomes a holder.  Returns how many blocks were adopted."""
        bs = self.block_size
        n = len(block_ids)
        if n * bs > len(tokens):
            raise PrefixIndexError(
                f"insert of {n} blocks needs {n * bs} tokens, "
                f"got {len(tokens)}"
            )
        children = self._children
        now = self._tick()
        adopted = 0
        for j in range(n):
            key = self._key(tokens, j, bs)
            node = children.get(key)
            if node is None:
                b = int(block_ids[j])
                if b in self._blocks:
                    raise PrefixIndexError(
                        f"block {b} is already indexed under another "
                        f"prefix — one block, one owner chain"
                    )
                self.allocator.retain([b])
                node = children[key] = _Node(key, b, now)
                self._blocks.add(b)
                adopted += 1
            node.last_used = now
            children = node.children
        self.inserted += adopted
        return adopted

    # ---- eviction (under pool pressure) ------------------------------------

    def _evictable_leaves(self):
        """Yield ``(parent_children, key, node)`` for every leaf whose
        block has no live holder beyond the index itself."""
        stack = [self._children]
        while stack:
            children = stack.pop()
            for key, node in children.items():
                if node.children:
                    stack.append(node.children)
                elif self.allocator.refcount(node.block) == 1:
                    yield children, key, node

    def evict(self, want: int) -> int:
        """Release up to ``want`` blocks by evicting LRU leaves whose
        only holder is the index.  Entries shared with live sequences
        are not evictable (releasing them would free nothing — the
        sequence still holds them) and interior nodes fall as their
        children do.  Returns how many blocks were released."""
        freed = 0
        while freed < max(int(want), 0):
            best = None
            for children, key, node in self._evictable_leaves():
                rank = (node.last_used, node.seq)
                if best is None or rank < best[0]:
                    best = (rank, children, key, node)
            if best is None:
                break
            _, children, key, node = best
            del children[key]
            self._blocks.discard(node.block)
            self.allocator.release([node.block])
            self.evictions += 1
            freed += 1
            if self.on_evict is not None:
                self.on_evict(node.block)
        return freed

    def clear(self) -> int:
        """Release every index-held block (the drain path: after this,
        all refcounts the index contributed are gone and a leak check
        can demand the free list be whole again).  Returns the count."""
        n = 0
        stack = [self._children]
        while stack:
            children = stack.pop()
            for node in children.values():
                self.allocator.release([node.block])
                n += 1
                stack.append(node.children)
        self._children = {}
        self._blocks = set()
        return n

    # ---- invariants --------------------------------------------------------

    def check(self) -> None:
        """Loud structural audit: every node's key is exactly one block
        wide, its block is allocated with the index among its holders,
        and no block is indexed twice."""
        seen: set = set()
        stack = [self._children]
        while stack:
            children = stack.pop()
            for key, node in children.items():
                if len(key) != self.block_size:
                    raise PrefixIndexError(
                        f"node key width {len(key)} != block_size "
                        f"{self.block_size}"
                    )
                if key != node.key:
                    raise PrefixIndexError(
                        f"node filed under {key} carries key {node.key}"
                    )
                if self.allocator.refcount(node.block) < 1:
                    raise PrefixIndexError(
                        f"indexed block {node.block} has no holders "
                        f"(refcount 0) — the index's reference leaked"
                    )
                if node.block in seen:
                    raise PrefixIndexError(
                        f"block {node.block} indexed twice"
                    )
                seen.add(node.block)
                stack.append(node.children)
        if seen != self._blocks:
            raise PrefixIndexError(
                f"block set drifted: walk found {sorted(seen)}, "
                f"tracker holds {sorted(self._blocks)}"
            )

    def key_paths(self) -> list:
        """Every root-to-node key path, sorted — the deterministic-keying
        witness: two replicas fed the same requests produce identical
        paths (block ids may differ; the KEYS are the contract)."""
        return [path for path, _ in self.node_paths()]

    def node_paths(self) -> list:
        """Every ``(root-to-node key path, block id)`` pair, sorted by
        path — the drain-handoff export walk: the path IS the token
        prefix the node's block was computed from, so a successor can
        recompute the block from the path alone (the block id is local
        to THIS replica's pool and never travels)."""
        out = []
        stack = [((), self._children)]
        while stack:
            prefix, children = stack.pop()
            for key, node in children.items():
                path = prefix + (key,)
                out.append((path, node.block))
                stack.append((path, node.children))
        return sorted(out)
