"""The serving engine: paged cache + continuous batcher + the model.

PyTorch counterpart of ``flextree_tpu/serving/engine.py``.  One
:class:`ServingEngine` is one replica on one device: it owns a paged K/V
pool, a :class:`~.batcher.ContinuousBatcher` and the model, and
``step()`` is one scheduling round:

1. **resume** — preempted sequences re-enter free slots first (swap-in
   scatter of their saved K/V, or prefill-replay recompute);
2. **admit** — queued requests enter free slots under the block
   (reservation or on-demand) and prefill-token budgets; each runs its
   prefill (suffix only on a prefix-cache hit), scatters its K/V into its
   blocks and emits its first token — the TTFT moment;
3. **grow** — on-demand admission allocates each active sequence's next
   block as its length crosses a block boundary; pool exhaustion preempts
   the newest resident sequence until the rest fit;
4. **decode** — one paged decode step over all S slots.  With
   ``fused=True`` (the default) attention runs the CUDA kernel on the
   card (``decode_impl="cuda"``) or the plain stream
   (``decode_impl="torch"``, and on the CPU); ``fused=False`` is the
   gather oracle;
5. **retire** — finished sequences (stop token or ``max_new_tokens``)
   free their blocks and land in ``completed``.

The model runs eagerly: no compile step, so ``warmup`` only launches one
decode round.  The pools are updated in place.  Sampling is host-side
over the fetched logits row: greedy is ``np.argmax``; a sampled request
draws each token from a ``torch.Generator`` seeded from ``(seed, token
index)``, so its tokens are a function of its seed alone — the same
whatever else shares the batch and across preemption.  (``jax.random``'s
bits cannot be reproduced, so sampled tokens differ from the JAX
engine's; greedy tokens are the same.)

Not ported yet: prefill/decode migration, the prefix drain handoff and
the per-round cost-model feedback of the JAX engine.
"""

from __future__ import annotations

import dataclasses
import time
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from ..models.generate import prefill, prefill_suffix, sample_token
from ..models.transformer import TransformerConfig, cast_params
from ..obs import MetricsRegistry, record_event
from .batcher import BatcherConfig, ContinuousBatcher, Request, SeqState
from .kv_cache import (
    CacheExhausted,
    PagedCacheConfig,
    gather_seq,
    init_pools,
    make_paged_decode_fn,
    write_prefill,
    write_prefill_at,
    write_swapped,
)

# cache-occupancy histogram buckets: fractions of the allocatable pool in
# use, observed once per scheduling round
_OCCUPANCY_BUCKETS = tuple(round(0.1 * i, 1) for i in range(1, 11))

__all__ = ["CompletedRequest", "ServingEngine"]

# injection point for tests (patch this, not time.monotonic)
_now = time.monotonic


def _token_seed(seed: int, index: int) -> int:
    """The generator seed of a sampled request's ``index``-th token."""
    ss = np.random.SeedSequence((int(seed) % (1 << 64), int(index)))
    return int(ss.generate_state(1, np.uint64)[0])


@dataclasses.dataclass(frozen=True)
class CompletedRequest:
    """A finished request's tokens and timestamps (all on the ``_now``
    clock): ``ttft_s = first_token_s - arrival_s``; per-token decode
    latency = ``(done_s - first_token_s) / (n - 1)``."""

    rid: int
    tokens: np.ndarray
    arrival_s: float
    admitted_s: float
    first_token_s: float
    done_s: float
    token_times: tuple = ()

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def ttft_s(self) -> float:
        return self.first_token_s - self.arrival_s

    @property
    def per_token_s(self) -> float:
        if self.n_tokens <= 1:
            return 0.0
        return (self.done_s - self.first_token_s) / (self.n_tokens - 1)


class ServingEngine:
    def __init__(
        self,
        params,
        cfg: TransformerConfig,
        pcfg: PagedCacheConfig,
        bcfg: BatcherConfig | None = None,
        metrics: MetricsRegistry | None = None,
        fused: bool = True,
        decode_impl: str = "cuda",
        slo_window_s: float = 10.0,
        device=None,
    ):
        if decode_impl not in ("cuda", "torch"):
            raise ValueError(f"unknown decode_impl {decode_impl!r}")
        self.device = resolve_device(device)
        self.cfg = cfg
        self.pcfg = pcfg
        self.bcfg = bcfg or BatcherConfig()
        self.fused = bool(fused)
        self.decode_impl = decode_impl
        # the weights on the device, matrices cast once to the compute
        # dtype (the functions' own casts are then no-ops)
        self.params = cast_params(params, cfg.dtype, self.device)
        self.metrics = metrics if metrics is not None else MetricsRegistry()
        # TTFT carries the SLO, so it is the windowed histogram
        self.slo_window_s = float(slo_window_s)
        self.metrics.windowed_histogram(
            "serve.ttft_ms", interval_s=self.slo_window_s / 10.0, intervals=10
        )
        self.batcher = ContinuousBatcher(pcfg, self.bcfg)
        self.pools = init_pools(cfg, pcfg, self.device)
        self._decode = make_paged_decode_fn(cfg, fused=self.fused,
                                            impl=decode_impl)
        self.completed: dict = {}
        self.steps = 0
        self.decode_steps = 0
        # windowed prefix hit-rate over the SLO window (admissions only)
        self._prefix_window: deque = deque()
        if self.batcher.prefix_index is not None:
            self.batcher.prefix_index.on_evict = self._on_prefix_evict

    # ---- intake ------------------------------------------------------------

    def submit(self, request: Request) -> bool:
        """Queue a request (stamping arrival if the caller didn't)."""
        if request.arrival_s == 0.0:
            request = dataclasses.replace(request, arrival_s=_now())
        ok = self.batcher.submit(request)
        self.metrics.counter(
            "serve.submitted" if ok else "serve.rejected"
        ).inc()
        if not ok:
            record_event(
                "serve_reject", rid=request.rid,
                reason=self.batcher.rejected[-1][1],
            )
        return ok

    @property
    def idle(self) -> bool:
        return self.batcher.idle

    # ---- the scheduling round ----------------------------------------------

    def step(self) -> dict:
        """One resume → admit → grow → decode → retire round; returns
        counters."""
        t0 = _now()
        resumed = self.batcher.try_resume(t0)
        for slot, state, kv in resumed:
            self._resume_slot(slot, state, kv)
        admitted = self.batcher.try_admit(t0)
        if self.batcher.admit_blocked is not None:
            rid, want, free = self.batcher.admit_blocked
            self.metrics.counter("serve.admit_blocked").inc()
            record_event("serve_admit_blocked", rid=rid, want=want, free=free)
        for slot, state in admitted:
            record_event(
                "serve_admit", rid=state.rid, slot=slot,
                prompt_len=state.request.prompt_len,
                blocks=len(state.block_ids),
            )
            self._prefill_slot(slot, state)
        preempted = self._grow_with_preemption()
        active = self.batcher.active_slots()
        if active:
            tables, lengths, tokens, _ = self.batcher.batch_arrays()
            dev = self.device
            logits = self._decode(
                self.params, self.pools,
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(lengths).to(dev),
                torch.from_numpy(tokens).to(dev),
            )
            logits = logits.cpu().numpy()  # host fetch = the step boundary
            now = _now()
            for slot in active:
                tok = self._pick(slot, logits[slot])
                self.batcher.record_decode_token(slot, tok, now)
            self.decode_steps += 1
            self.metrics.counter("serve.decode_tokens").inc(len(active))
            record_event("serve_decode", n_active=len(active))
        finished = self.batcher.retire_ready()
        for _, state in finished:
            self._complete(state)
        self.steps += 1
        m = self.metrics
        m.counter("serve.rounds").inc()
        m.counter("serve.admitted").inc(len(admitted))
        m.counter("serve.finished").inc(len(finished))
        m.gauge("serve.active_slots").set(self.batcher.num_active)
        free = self.batcher.allocator.num_free
        total = self.pcfg.num_blocks - 1
        m.gauge("serve.free_blocks").set(free)
        m.gauge("serve.active_blocks").set(total - free)
        m.gauge("serve.preempted_seqs").set(len(self.batcher.preempted))
        m.histogram(
            "serve.cache_occupancy", buckets=_OCCUPANCY_BUCKETS
        ).observe((total - free) / total)
        m.histogram("serve.round_ms").observe((_now() - t0) * 1e3)
        return {
            "admitted": len(admitted),
            "resumed": len(resumed),
            "preempted": preempted,
            "decoded": len(active),
            "finished": len(finished),
        }

    def run_until_idle(self, max_steps: int = 100_000) -> None:
        for _ in range(max_steps):
            if self.idle:
                return
            self.step()
        raise RuntimeError(f"engine not idle after {max_steps} steps")

    # ---- internals ---------------------------------------------------------

    def _grow_with_preemption(self) -> int:
        """On-demand growth with the exhaustion → preempt loop: evict the
        newest resident sequence until every survivor's next decode block
        allocates.  Returns how many sequences were preempted; raises when
        a lone sequence cannot grow."""
        preempted = 0
        while True:
            try:
                self.batcher.grow_for_decode()
                return preempted
            except CacheExhausted:
                victim = self.batcher.pick_victim()
                if victim is None:
                    raise
                self._preempt_slot(victim)
                preempted += 1

    def _preempt_slot(self, slot: int) -> None:
        state = self.batcher.slots[slot]
        mode = self.bcfg.preempt
        kv = None
        if mode == "swap":
            # host copies of the written positions, taken now, before the
            # freed blocks are rewritten
            view = gather_seq(self.pools, state.block_ids, length=state.length)
            kv = {kind: [t.to("cpu", copy=True) for t in view[kind]]
                  for kind in ("k", "v")}
            swapped = sum(t.numel() * t.element_size()
                          for kind in ("k", "v") for t in kv[kind])
            self.metrics.counter("serve.swap_out_bytes").inc(swapped)
            self.metrics.counter("serve.swap_outs").inc()
            record_event(
                "serve_swap_out", rid=state.rid, length=state.length,
                bytes=swapped,
            )
        blocks = len(state.block_ids)
        self.batcher.preempt(slot, kv)
        self.metrics.counter("serve.preempts").inc()
        record_event(
            "serve_preempt", rid=state.rid, slot=slot, mode=mode,
            length=state.length, blocks_freed=blocks,
            n_generated=len(state.generated),
        )

    def _resume_slot(self, slot: int, state: SeqState, kv) -> None:
        req = state.request
        n = len(state.block_ids)
        bs = self.pcfg.block_size
        if kv is not None:
            # swap-in: the exact saved bytes back, zero-padded to whole
            # blocks (the pad lies past the causal bound)
            padded = {"k": [], "v": []}
            for kind in ("k", "v"):
                for a in kv[kind]:
                    full = torch.zeros((n * bs, *a.shape[1:]), dtype=a.dtype)
                    full[: a.shape[0]] = a
                    padded[kind].append(full)
            write_swapped(self.pools, padded, state.block_ids)
        else:
            # recompute: replay the tokens whose K/V were dropped (prompt
            # + already-written decode tokens) through prefill
            written = np.concatenate([
                np.asarray(req.prompt, np.int64),
                np.asarray(state.generated[: state.length - req.prompt_len],
                           np.int64),
            ])
            _, cache = prefill(self.params, self._tokens(written)[None],
                               self.cfg, self.pcfg.max_len)
            write_prefill(self.pools, cache, state.block_ids)
        self.metrics.counter("serve.resumes").inc()
        record_event(
            "serve_resume", rid=state.rid, slot=slot,
            mode="swap" if kv is not None else "recompute",
            length=state.length, blocks=n,
        )

    def _tokens(self, ids) -> torch.Tensor:
        return torch.as_tensor(np.asarray(ids, np.int64)).to(self.device)

    def _on_prefix_evict(self, block: int) -> None:
        self.metrics.counter("serve.prefix_evictions").inc()
        record_event("serve_prefix_evict", block=int(block))

    def _note_prefix_admission(self, hit: bool, now: float) -> None:
        """One admission's hit/miss into the windowed hit-rate gauge."""
        w = self._prefix_window
        w.append((now, 1 if hit else 0))
        cutoff = now - self.slo_window_s
        while w and w[0][0] < cutoff:
            w.popleft()
        self.metrics.gauge("serve.prefix_hit_rate").set(
            sum(h for _, h in w) / len(w)
        )

    def release_prefix_cache(self) -> int:
        """Drop every index-held block reference.  Returns how many
        entries were released."""
        idx = self.batcher.prefix_index
        return idx.clear() if idx is not None else 0

    def _prefill_slot(self, slot: int, state: SeqState) -> None:
        t0 = _now()
        req = state.request
        prompt = self._tokens(req.prompt)
        c = state.cached_tokens
        if c > 0:
            bs = self.pcfg.block_size
            # the prefix K/V lives in the shared blocks — plus, for a
            # full-prompt hit, the COW fork's source
            chain = list(state.block_ids[: state.shared_blocks])
            if state.cow_src is not None:
                chain.append(state.cow_src)
            view = gather_seq(self.pools, chain, length=c)
            logits, cache = prefill_suffix(
                self.params, prompt[None, c:],
                {kind: [t[None] for t in view[kind]] for kind in ("k", "v")},
                self.cfg, self.pcfg.max_len,
            )
            # scatter only from the first non-shared block on: the shared
            # blocks below are never rewritten
            sb = c // bs
            write_prefill_at(self.pools, cache, state.block_ids[sb:], sb)
            if state.cow_src is not None:
                self.metrics.counter("serve.prefix_cow").inc()
                record_event(
                    "serve_prefix_cow", rid=req.rid,
                    src=int(state.cow_src), dst=int(state.block_ids[sb]),
                )
                self.batcher.allocator.release([state.cow_src])
                state.cow_src = None
            self.metrics.counter("serve.prefix_hits").inc()
            self.metrics.counter("serve.cached_tokens_saved").inc(c)
            record_event(
                "serve_prefix_hit", rid=req.rid, cached_tokens=c,
                shared_blocks=state.shared_blocks,
                suffix_tokens=req.prompt_len - c,
            )
        else:
            logits, cache = prefill(self.params, prompt[None], self.cfg,
                                    self.pcfg.max_len)
            write_prefill(self.pools, cache, state.block_ids)
            if self.batcher.prefix_index is not None:
                self.metrics.counter("serve.prefix_misses").inc()
        if self.batcher.prefix_index is not None:
            self._note_prefix_admission(c > 0, t0)
        tok = self._pick(slot, logits[0].cpu().numpy())
        now = _now()
        self.batcher.record_first_token(slot, tok, now)
        self.metrics.histogram("serve.ttft_ms").observe(
            (now - req.arrival_s) * 1e3
        )
        record_event(
            "serve_prefill", rid=req.rid, slot=slot,
            prompt_len=req.prompt_len, cached_tokens=c,
            measured_us=round((now - t0) * 1e6, 3),
        )

    def _pick(self, slot: int, logits_row: np.ndarray) -> int:
        state = self.batcher.slots[slot]
        req = state.request
        if req.temperature <= 0:
            return int(np.argmax(logits_row))
        gen = torch.Generator().manual_seed(
            _token_seed(req.seed, len(state.generated))
        )
        tok = sample_token(
            torch.from_numpy(logits_row)[None],
            temperature=req.temperature, top_k=req.top_k, generator=gen,
        )
        return int(tok[0])

    def _complete(self, state: SeqState) -> None:
        done = CompletedRequest(
            rid=state.rid,
            tokens=np.asarray(state.generated, np.int32),
            arrival_s=state.request.arrival_s,
            admitted_s=state.admitted_s,
            first_token_s=state.first_token_s,
            done_s=state.done_s,
            token_times=tuple(state.token_times),
        )
        self.completed[state.rid] = done
        if done.n_tokens > 1:
            self.metrics.histogram("serve.per_token_ms").observe(
                done.per_token_s * 1e3
            )
        record_event("serve_retire", rid=state.rid, n_tokens=done.n_tokens,
                     ttft_ms=round(done.ttft_s * 1e3, 3))

    def report(self) -> dict:
        """The replica's accounting: a view over its metrics registry plus
        the loop counters."""
        return {
            "steps": self.steps,
            "decode_steps": self.decode_steps,
            "completed": len(self.completed),
            **self.metrics.snapshot(),
        }

    def warmup(self) -> None:
        """Launch one decode round over all-inactive slots before a timed
        run, so first-call set-up (kernel build and load, library handles)
        lands outside the first requests' latency.  Its writes go to the
        null block only, as every inactive slot's do."""
        S, P = self.bcfg.slots, self.pcfg.blocks_per_seq
        zeros = torch.zeros(S, dtype=torch.int32, device=self.device)
        self._decode(
            self.params, self.pools,
            torch.zeros((S, P), dtype=torch.int32, device=self.device),
            zeros, zeros,
        )
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)
