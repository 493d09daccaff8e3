"""Continuous batcher: request queue, admission by token budget, slots.

The port's own copy of ``flextree_tpu/serving/batcher.py`` (which imports
no JAX, but the port imports nothing of the JAX package).

The batcher is a pure host-side state machine — no tensors in this
module — so every transition is unit-testable without a device.  State:

- a FIFO **queue** of submitted :class:`Request`\\ s (head-of-line order
  is preserved; a request that does not fit blocks the ones behind it —
  no starvation of big requests by a stream of small ones);
- ``slots`` decode **slots**, each empty or holding a :class:`SeqState`.
  The slot count is the decode batch size S: the paged decode always
  runs S rows, empty slots ride along as masked no-ops (their pool
  writes land in the null block).

**Admission math** (``try_admit``) comes in two modes
(``BatcherConfig.admission``):

- ``"reserve"`` (the conservative default): a request reserves ALL
  ``ceil((prompt_len + max_new_tokens) / block_size)`` blocks at
  admission — wasteful (a request that stops early returns blocks it
  never wrote), but mid-decode exhaustion is structurally impossible and
  an admitted request always runs to retirement.
- ``"ondemand"`` (the vLLM-style allocator): admission reserves only the
  PROMPT's blocks; decode blocks are allocated one at a time as each
  sequence's length crosses a block boundary (``grow_for_decode``).  The
  same pool now keeps more sequences resident — and pool exhaustion
  mid-decode becomes structurally possible, which is what the
  **preemption** machinery below exists for.

**Preemption** (on-demand mode only): when ``grow_for_decode`` cannot
allocate, the engine picks the NEWEST resident sequence
(``pick_victim`` — newest-first minimizes wasted work and cannot starve
the oldest), swaps its written K/V out to host memory (or drops it for
prefill-replay recompute), and ``preempt`` frees its blocks and parks it
on the ``preempted`` queue.  Preempted sequences resume with strict
priority over fresh admissions (``try_resume`` runs first and
``try_admit`` refuses to admit past a non-empty preempted queue — fresh
short requests must never starve a half-done long one), and a resumed
sequence continues bit-identically from its saved state.

A per-step **prefill token budget** caps how much prefill work joins one
step, bounding the decode stall that admission imposes on already-running
sequences (join-at-step: new requests prefill into free slots while
running sequences keep decoding on the next step).

**Retirement** (``retire_ready``): a sequence is done when it has emitted
``max_new_tokens`` tokens or a token in its ``stop_tokens``.  Retirement
frees the slot and returns every held block to the allocator
immediately — freed blocks resume preempted sequences or admit queued
requests on the very next step.

**Prefix cache** (``BatcherConfig.prefix_cache``, off by default): a
:class:`~.prefix_index.PrefixIndex` shares full
prompt blocks across requests.  Admission matches the longest cached
block-aligned prefix, RETAINS those blocks instead of allocating, and
the engine prefills only the suffix; retirement inserts the sequence's
full prompt blocks into the index and RELEASES everything it held;
pool pressure evicts idle index entries before blocking admission.
Still a pure host-side state machine: the index stores token ids and
block ids, never tensors.
"""

from __future__ import annotations

import dataclasses
from collections import deque

import numpy as np

from .kv_cache import BlockAllocator, CacheExhausted, PagedCacheConfig, NULL_BLOCK
from .prefix_index import PrefixIndex

__all__ = [
    "Request",
    "SeqState",
    "PreemptedSeq",
    "BatcherConfig",
    "ContinuousBatcher",
]


@dataclasses.dataclass(frozen=True)
class Request:
    """One generation request.  ``prompt`` is a 1-D int32 array;
    ``stop_tokens`` retire the sequence early; sampling knobs mirror
    ``models.generate`` (greedy by default, ``seed`` threads a
    deterministic key when ``temperature > 0``)."""

    rid: int
    prompt: np.ndarray
    max_new_tokens: int
    stop_tokens: tuple = ()
    temperature: float = 0.0
    top_k: int | None = None
    seed: int | None = None
    arrival_s: float = 0.0

    @property
    def prompt_len(self) -> int:
        return int(np.asarray(self.prompt).shape[0])


@dataclasses.dataclass
class SeqState:
    """A resident sequence: its reservation, progress, and timestamps."""

    request: Request
    block_ids: list
    length: int  # cache positions filled (prompt + written decode tokens)
    pending_token: int  # last emitted token, not yet written to the cache
    generated: list  # emitted tokens, stop token included
    done: bool = False
    admitted_s: float = 0.0
    first_token_s: float = 0.0
    done_s: float = 0.0
    admit_seq: int = 0  # monotonic admission stamp: victim = largest
    preempts: int = 0  # times this sequence was preempted
    # prefix-cache admission state: how many leading cache positions came
    # from the index (the engine prefills only the rest), how many leading
    # block_ids are SHARED (retained, never written by this sequence), and
    # the shared source of a copy-on-write fork — the engine gathers the
    # mid-block prefix from it, then releases it
    cached_tokens: int = 0
    shared_blocks: int = 0
    cow_src: int | None = None
    # one ``_now`` stamp per emitted token (first token included): the
    # inter-token latency distribution is ``diff(token_times)`` — the
    # decode-SLO quantity the disagg bench holds p99 floors against,
    # which the mean ``per_token_s`` on CompletedRequest cannot carry
    token_times: list = dataclasses.field(default_factory=list)

    @property
    def rid(self) -> int:
        return self.request.rid


@dataclasses.dataclass
class PreemptedSeq:
    """A sequence evicted mid-decode: its full progress plus the swapped
    K/V (host-side per-layer arrays for ``length`` positions), or ``kv =
    None`` when the engine chose prefill-replay recompute."""

    state: SeqState
    kv: object = None


@dataclasses.dataclass(frozen=True)
class BatcherConfig:
    """``slots``: the decode batch size S.
    ``max_prefill_tokens_per_step``: join-at-step budget — total prompt
    tokens admitted per engine step (at least one request is always
    admitted when a slot and blocks are free, so a long prompt cannot
    deadlock itself).
    ``admission``: ``"reserve"`` (whole budget up front, no preemption
    possible — the conservative default) or ``"ondemand"`` (prompt
    blocks only; decode grows per block boundary, exhaustion preempts).
    ``preempt``: what the engine saves when it evicts — ``"swap"`` (K/V
    bytes to host memory; resume is a scatter, bit-identical by
    construction) or ``"recompute"`` (drop the K/V, replay
    prompt+generated through prefill on resume — cheaper for short
    contexts, pays forward FLOPs and a per-length compile).
    ``prefix_cache``: enable the cross-request prefix index — admission
    shares cached full-block prefixes and prefills only the suffix;
    retirement releases blocks into the index instead of freeing them
    (off by default: a warm index intentionally keeps retired prompt
    blocks out of the free list, which changes the pool-accounting
    invariants callers may assert)."""

    slots: int = 4
    max_prefill_tokens_per_step: int = 256
    admission: str = "reserve"
    preempt: str = "swap"
    prefix_cache: bool = False

    def __post_init__(self):
        if self.admission not in ("reserve", "ondemand"):
            raise ValueError(f"unknown admission mode {self.admission!r}")
        if self.preempt not in ("swap", "recompute"):
            raise ValueError(f"unknown preempt mode {self.preempt!r}")


class ContinuousBatcher:
    def __init__(self, pcfg: PagedCacheConfig, bcfg: BatcherConfig):
        self.pcfg = pcfg
        self.bcfg = bcfg
        self.allocator = BlockAllocator(pcfg.num_blocks)
        self.prefix_index = (
            PrefixIndex(pcfg.block_size, self.allocator)
            if bcfg.prefix_cache else None
        )
        self.slots: list = [None] * bcfg.slots
        self.queue: deque = deque()
        self.preempted: deque = deque()  # PreemptedSeq, resume-first FIFO
        self.rejected: list = []  # (rid, reason) for oversized requests
        self.admit_blocked: tuple | None = None  # (rid, want, free) last round
        self._admit_seq = 0  # monotonic stamp for newest-first victimhood

    @property
    def ondemand(self) -> bool:
        return self.bcfg.admission == "ondemand"

    # ---- intake ------------------------------------------------------------

    def submit(self, request: Request) -> bool:
        """Queue a request; oversized ones (they could NEVER be admitted)
        are rejected now, loudly, instead of clogging the queue head."""
        total = request.prompt_len + request.max_new_tokens
        if request.prompt_len < 1:
            self.rejected.append((request.rid, "empty prompt"))
            return False
        if total > self.pcfg.max_len:
            self.rejected.append(
                (request.rid,
                 f"prompt+max_new {total} exceeds max_len {self.pcfg.max_len}")
            )
            return False
        if self.pcfg.blocks_for(total) > self.pcfg.num_blocks - 1:
            # the pool can NEVER hold it: under reservation it would wedge
            # the queue head forever, under on-demand it would livelock the
            # preemption loop (nothing else to evict frees enough)
            self.rejected.append(
                (request.rid,
                 f"needs {self.pcfg.blocks_for(total)} blocks, pool holds "
                 f"{self.pcfg.num_blocks - 1}")
            )
            return False
        if request.temperature > 0 and request.seed is None:
            # reject BEFORE admission: discovered mid-prefill this would
            # wedge the slot (blocks reserved, no sampler key)
            self.rejected.append(
                (request.rid, "temperature > 0 requires seed=")
            )
            return False
        self.queue.append(request)
        return True

    # ---- admission ---------------------------------------------------------

    def blocks_needed(self, request: Request) -> int:
        """Blocks the request needs AT ADMISSION: the whole prompt+output
        budget under reservation, the prompt only under on-demand."""
        if self.ondemand:
            return self.pcfg.blocks_for(request.prompt_len)
        return self.pcfg.blocks_for(
            request.prompt_len + request.max_new_tokens
        )

    def _next_admit_seq(self) -> int:
        self._admit_seq += 1
        return self._admit_seq

    def _alloc_with_evict(self, n: int) -> list:
        """Allocate ``n`` blocks, evicting idle prefix-index entries
        under pool pressure first (LRU, index-only holders) — live
        sequences always outrank cold cache."""
        try:
            return self.allocator.alloc(n)
        except CacheExhausted:
            if self.prefix_index is None:
                raise
            self.prefix_index.evict(n - self.allocator.num_free)
            return self.allocator.alloc(n)

    def _match_prefix(self, req: Request):
        """Look up the longest cached block-aligned prefix for ``req``.

        Returns ``(shared, cow_src, cached_tokens)``: the leading block
        ids to share outright (retained here), the shared block to
        copy-on-write fork when the cached chain reaches past them (its
        tail positions must be re-derived into a private copy — never
        written in place in the shared original), and how many leading
        cache positions the engine's prefill may skip.

        A hit always leaves at least TWO suffix tokens: the last prompt
        token must run through the model for its logits regardless, and
        a one-token suffix would put the attention matmuls in the
        ``Tq=1`` shape class, which a matrix library may run with a
        different accumulation order than the multi-row prefill — the
        same admission rule as the JAX package.  So shared blocks are
        capped at ``(prompt_len - 2) // block_size`` and a full-chain
        hit re-derives the final two positions (the second-to-last one
        landing mid-block in the COW fork)."""
        if self.prefix_index is None:
            return [], None, 0
        matched = self.prefix_index.match(np.asarray(req.prompt))
        if not matched:
            return [], None, 0
        bs = self.pcfg.block_size
        n_shared = min(len(matched), (req.prompt_len - 2) // bs)
        shared = matched[:n_shared]
        cow_src = matched[n_shared] if len(matched) > n_shared else None
        cached = (
            req.prompt_len - 2 if cow_src is not None else n_shared * bs
        )
        if cached <= 0:
            return [], None, 0
        self.allocator.retain(shared)
        if cow_src is not None:
            # hold the fork source until the engine has gathered its
            # bytes — an eviction between admission and prefill would
            # otherwise hand the suffix prefill a recycled block
            self.allocator.retain([cow_src])
        return shared, cow_src, cached

    def try_admit(self, now_s: float = 0.0) -> list:
        """Admit queued requests into free slots under the block and
        prefill-token budgets.  Returns ``[(slot_idx, SeqState), ...]``
        for the engine to prefill; the states are already resident (the
        allocation happened here — all-or-nothing per request).  Sets
        ``admit_blocked`` when the queue head is blocked on BLOCKS (not
        slots) — the engine's ``serve_admit_blocked`` signal.

        With the prefix cache on, the queue head's longest cached
        block-aligned prefix is shared (retained) instead of allocated,
        only the SUFFIX blocks are taken from the free list, and the
        prefill-token budget is charged for the suffix alone — a cache
        hit is cheap to admit in exactly the proportion it is cheap to
        prefill."""
        if self.preempted:
            # resume-first, strictly: fresh admissions must not take the
            # blocks a half-done preempted sequence is waiting for (and
            # admit_blocked keeps whatever try_resume just recorded —
            # clearing it here would wipe the resume-blocked signal)
            return []
        self.admit_blocked = None
        admitted = []
        budget = self.bcfg.max_prefill_tokens_per_step
        while self.queue:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            req = self.queue[0]
            shared, cow_src, cached = self._match_prefix(req)
            suffix_tokens = req.prompt_len - cached
            retained = shared + ([cow_src] if cow_src is not None else [])
            if admitted and suffix_tokens > budget:
                # join-at-step budget spent; next step picks it up
                self.allocator.release(retained)
                break
            try:
                blocks = self._alloc_with_evict(
                    self.blocks_needed(req) - len(shared)
                )
            except CacheExhausted as e:
                # FIFO head-of-line: wait for retirements
                self.allocator.release(retained)
                self.admit_blocked = (req.rid, e.want, e.free)
                break
            self.queue.popleft()
            budget -= suffix_tokens
            state = SeqState(
                request=req,
                block_ids=shared + blocks,
                length=req.prompt_len,
                pending_token=-1,
                generated=[],
                admitted_s=now_s,
                admit_seq=self._next_admit_seq(),
                cached_tokens=cached,
                shared_blocks=len(shared),
                cow_src=cow_src,
            )
            slot = free_slots[0]
            self.slots[slot] = state
            admitted.append((slot, state))
        return admitted

    def admit_migrated(self, request: Request, first_token: int,
                       now_s: float = 0.0):
        """Admit a sequence whose PREFILL ran on another replica: its KV
        blocks arrive over the wire, its first token is already emitted.

        Mirrors ``try_admit``'s discipline — resume-first (a migrated
        arrival must not take the blocks a half-done preempted sequence
        is waiting for), all-or-nothing allocation, ``admit_blocked`` set
        on block pressure — but skips the queue: migration is an
        admit-or-refuse handshake, so a sequence that cannot land NOW is
        refused back to the prefill side rather than parked.  Returns
        ``(slot_idx, SeqState)`` with the state resident (length =
        prompt_len, first token recorded) and the block ids ready for
        the engine's import scatter, or ``None`` to refuse.  The caller
        still owes the decode-token recording from the next step on."""
        if self.preempted:
            return None
        free_slots = [i for i, s in enumerate(self.slots) if s is None]
        if not free_slots:
            return None
        try:
            blocks = self._alloc_with_evict(self.blocks_needed(request))
        except CacheExhausted as e:
            self.admit_blocked = (request.rid, e.want, e.free)
            return None
        state = SeqState(
            request=request,
            block_ids=blocks,
            length=request.prompt_len,
            pending_token=int(first_token),
            generated=[int(first_token)],
            admitted_s=now_s,
            first_token_s=now_s,
            admit_seq=self._next_admit_seq(),
        )
        state.token_times.append(now_s)
        self._maybe_finish(state, now_s)
        slot = free_slots[0]
        self.slots[slot] = state
        return slot, state

    # ---- on-demand growth / preemption / resume ----------------------------

    def blocks_for_resume(self, state: SeqState) -> int:
        """Blocks a resumed sequence needs right now: its ``length``
        written positions plus the current block its next decode write
        lands in (``length // bs + 1`` covers both, mid-block or not)."""
        return state.length // self.pcfg.block_size + 1

    def try_resume(self, now_s: float = 0.0) -> list:
        """Re-admit preempted sequences (FIFO, strict priority) into free
        slots.  Returns ``[(slot_idx, SeqState, kv), ...]`` for the engine
        to scatter (``kv`` is the swapped host K/V, or None for
        prefill-replay recompute).  All-or-nothing per sequence.  The
        resumed state KEEPS its original admission stamp: re-stamping
        would make it the newest resident and therefore the very next
        victim — a full swap-in immediately paid back out as a swap-out
        with zero tokens decoded."""
        self.admit_blocked = None
        resumed = []
        while self.preempted:
            free_slots = [i for i, s in enumerate(self.slots) if s is None]
            if not free_slots:
                break
            pre = self.preempted[0]
            try:
                blocks = self._alloc_with_evict(
                    self.blocks_for_resume(pre.state)
                )
            except CacheExhausted as e:
                self.admit_blocked = (pre.state.rid, e.want, e.free)
                break
            self.preempted.popleft()
            pre.state.block_ids = blocks
            slot = free_slots[0]
            self.slots[slot] = pre.state
            resumed.append((slot, pre.state, pre.kv))
        return resumed

    def grow_for_decode(self) -> list:
        """On-demand only: allocate the block each active sequence's next
        decode write needs, OLDEST first (so exhaustion lands on the
        newest, which is also the preemption victim).  Returns the slots
        that grew; raises :class:`CacheExhausted` when a needed block
        cannot be allocated — the engine's preemption trigger."""
        if not self.ondemand:
            return []
        grown = []
        order = sorted(
            self.active_slots(), key=lambda i: self.slots[i].admit_seq
        )
        for i in order:
            s = self.slots[i]
            need = s.length // self.pcfg.block_size + 1
            while len(s.block_ids) < need:
                s.block_ids.extend(self._alloc_with_evict(1))
                if i not in grown:
                    grown.append(i)
        return grown

    def pick_victim(self) -> int | None:
        """The preemption victim: the most recently ADMITTED resident
        (largest admission stamp; a resumed sequence keeps its original
        stamp, so it is never the immediate next victim of the swap-in
        it just paid for).  None when fewer than two sequences are
        resident — preempting the only one could never unblock anything."""
        active = self.active_slots()
        if len(active) < 2:
            return None
        return max(active, key=lambda i: self.slots[i].admit_seq)

    def preempt(self, slot: int, kv=None) -> SeqState:
        """Evict ``slot``: release every held block (shared prefix blocks
        just drop this holder — the index and any co-sharing sequence
        keep them alive), park the sequence (and the engine-saved ``kv``,
        if swapping) on the resume queue.  A resumed sequence gets
        all-private blocks, so its sharing bookkeeping resets here."""
        s = self.slots[slot]
        if s is None:
            raise ValueError(f"slot {slot} holds no sequence")
        self.allocator.release(s.block_ids)
        if s.cow_src is not None:  # unconsumed fork source (engine never
            self.allocator.release([s.cow_src])  # prefilled) — drop it
            s.cow_src = None
        s.block_ids = []
        s.shared_blocks = 0
        s.preempts += 1
        self.slots[slot] = None
        self.preempted.append(PreemptedSeq(state=s, kv=kv))
        return s

    # ---- the decode-step view ---------------------------------------------

    def active_slots(self) -> list:
        """Slots holding a live, not-yet-done sequence that has a pending
        token to write (i.e. participates in the next decode step)."""
        return [
            i for i, s in enumerate(self.slots)
            if s is not None and not s.done
        ]

    def batch_arrays(self):
        """(tables (S, P), lengths (S,), tokens (S,), active (S,)) int32 /
        bool numpy views of the current slots — inactive rows are
        all-NULL_BLOCK tables at length 0 with token 0 (masked no-ops)."""
        S, P = self.bcfg.slots, self.pcfg.blocks_per_seq
        tables = np.full((S, P), NULL_BLOCK, np.int32)
        lengths = np.zeros((S,), np.int32)
        tokens = np.zeros((S,), np.int32)
        active = np.zeros((S,), bool)
        for i, s in enumerate(self.slots):
            if s is None or s.done:
                continue
            tables[i, : len(s.block_ids)] = s.block_ids
            lengths[i] = s.length
            tokens[i] = s.pending_token
            active[i] = True
        return tables, lengths, tokens, active

    def record_first_token(self, slot: int, token: int, now_s: float) -> None:
        s = self.slots[slot]
        s.pending_token = int(token)
        s.generated.append(int(token))
        s.first_token_s = now_s
        s.token_times.append(now_s)
        self._maybe_finish(s, now_s)

    def record_decode_token(self, slot: int, token: int, now_s: float) -> None:
        """The decode step wrote ``pending_token``'s K/V at ``length`` and
        produced ``token`` for the next position."""
        s = self.slots[slot]
        s.length += 1
        s.pending_token = int(token)
        s.generated.append(int(token))
        s.token_times.append(now_s)
        self._maybe_finish(s, now_s)

    def _maybe_finish(self, s: SeqState, now_s: float) -> None:
        hit_stop = s.generated[-1] in s.request.stop_tokens
        if hit_stop or len(s.generated) >= s.request.max_new_tokens:
            s.done = True
            s.done_s = now_s

    # ---- retirement --------------------------------------------------------

    def retire_ready(self) -> list:
        """Release every done slot's blocks; returns ``[(slot_idx,
        SeqState)]`` for the finished sequences.

        With the prefix cache on, the sequence's FULL prompt blocks
        (``prompt_len // block_size`` of them — never the tail block
        decode wrote into) are first inserted into the index, which
        retains the ones it adopts; the release that follows then only
        returns the un-adopted remainder to the free list.  A sequence
        that was itself a cache hit walks the same trie path it was
        admitted from, so its shared blocks are found already indexed
        and adopted zero times."""
        finished = []
        for i, s in enumerate(self.slots):
            if s is not None and s.done:
                if self.prefix_index is not None:
                    full = s.request.prompt_len // self.pcfg.block_size
                    self.prefix_index.insert(
                        np.asarray(s.request.prompt), s.block_ids[:full]
                    )
                if s.cow_src is not None:  # defensive: engine clears this
                    self.allocator.release([s.cow_src])
                    s.cow_src = None
                self.allocator.release(s.block_ids)
                self.slots[i] = None
                finished.append((i, s))
        return finished

    # ---- introspection -----------------------------------------------------

    @property
    def num_active(self) -> int:
        return sum(1 for s in self.slots if s is not None)

    @property
    def idle(self) -> bool:
        return (
            not self.queue
            and not self.preempted
            and all(s is None for s in self.slots)
        )

    def inflight_requests(self) -> list:
        """Every submitted-but-unfinished request — queued, resident, or
        preempted.  The replica pool drains this to re-route off a dead
        replica; a preempted sequence missing here would be the silently
        lost request the exactly-once contract forbids."""
        out = [s.request for s in self.slots if s is not None]
        out.extend(p.state.request for p in self.preempted)
        out.extend(self.queue)
        return out
