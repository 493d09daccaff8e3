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

Prefill/decode disaggregation (the JAX engine's migration half): a
prefill replica's :meth:`ServingEngine.prefill_for_migration` runs the
prompt, exports its blocks (``kv_cache.export_blocks``, moved to the
host once as float32) and packs them for the wire
(``migration.pack_kv``), holding the blocks until
:meth:`~ServingEngine.release_exported`; a decode replica's
:meth:`~ServingEngine.admit_migrated` verifies the payload, lands it
(``batcher.admit_migrated``, ``kv_cache.write_imported``) and decodes
from there on the same kernel.  Each decode round's time is held
against the cost model's prediction (``serve.round_residual``,
``costs.predict_decode_round_us``); the prefix index drains to a handoff
document (:meth:`~ServingEngine.export_prefix_handoff`) that a successor
prewarms from.
"""

from __future__ import annotations

import dataclasses
import time
import zlib
from collections import deque

import numpy as np
import torch

from ..device import resolve_device
from ..models.generate import prefill, prefill_suffix, sample_token
from ..models.transformer import TransformerConfig, cast_params
from ..obs import MetricsRegistry, record_event
from .batcher import BatcherConfig, ContinuousBatcher, Request, SeqState
from .kv_cache import (
    NULL_BLOCK,
    CacheExhausted,
    PagedCacheConfig,
    export_blocks,
    gather_seq,
    init_pools,
    make_paged_decode_fn,
    write_imported,
    write_prefill,
    write_prefill_at,
    write_swapped,
)
from .migration import MigrationError, pack_kv, unpack_kv

# cache-occupancy histogram buckets: fractions of the allocatable pool in
# use, observed once per scheduling round
_OCCUPANCY_BUCKETS = tuple(round(0.1 * i, 1) for i in range(1, 11))

# relative-residual buckets for the serving feedback loop: |predicted -
# measured| / measured of each decode round vs the paged-decode cost
# estimate (serving/costs.py) — ratio-scaled, not ms-scaled
_RESIDUAL_BUCKETS = (0.05, 0.1, 0.2, 0.5, 1.0, 2.0, 5.0, 10.0)

# migration payload size buckets (bytes on the wire): small models ship
# KB, production shapes MB — one histogram covers both
_MIGRATION_BYTES_BUCKETS = (
    1 << 10, 1 << 12, 1 << 14, 1 << 16, 1 << 18, 1 << 20, 1 << 22, 1 << 24,
)

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
    # per-token ``_now`` stamps (first token included): consecutive
    # differences are the inter-token latency samples
    token_times: tuple = ()

    @property
    def n_tokens(self) -> int:
        return int(self.tokens.shape[0])

    @property
    def intervals_s(self) -> tuple:
        """Inter-token gaps (seconds), one per decode token."""
        return tuple(
            b - a for a, b in zip(self.token_times, self.token_times[1:])
        )

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
        # rid -> blocks held for an in-flight migration export; released
        # on the decode side's ack (or the abort path), never before: the
        # bytes on the wire are the only other copy of this state until
        # the receiver confirms it owns one
        self._exported: dict = {}
        # stretches every prefill by this many seconds per computed prompt
        # token (set by replica_main from FT_RPC_PREFILL_SLEEP; 0 = off)
        self.chaos_prefill_sleep_s = 0.0
        self._cost_params_cache = None
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
            # the batch frontier from the host's own lengths: the round
            # never reads a length back from the device
            max_len = int(lengths.max())
            dev = self.device
            t_dec = _now()
            logits = self._decode(
                self.params, self.pools,
                torch.from_numpy(tables).to(dev),
                torch.from_numpy(lengths).to(dev),
                torch.from_numpy(tokens).to(dev),
            )
            logits = logits.cpu().numpy()  # host fetch = the step boundary
            decode_s = _now() - t_dec
            now = _now()
            for slot in active:
                tok = self._pick(slot, logits[slot])
                self.batcher.record_decode_token(slot, tok, now)
            self.decode_steps += 1
            self.metrics.counter("serve.decode_tokens").inc(len(active))
            record_event("serve_decode", n_active=len(active))
            self._round_feedback(len(active), max_len, decode_s)
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

    def _round_feedback(
        self, n_active: int, max_len: int, measured_s: float
    ) -> None:
        """One decode round's measured time (the host clock around the
        round, which ends in the logits fetch) against the paged-decode
        cost estimate (``costs.predict_decode_round_us`` on this engine's
        device), observed into the ``serve.round_residual`` histogram and
        emitted as a ``serve_round_measured`` event."""
        from .costs import predict_decode_round_us

        pred = predict_decode_round_us(
            self.cfg, self.pcfg, n_active, max_len, self._cost_params(),
            device=self.device,
        )
        measured_us = float(measured_s) * 1e6
        predicted_us = pred["predicted_us"]
        rel = abs(predicted_us - measured_us) / max(measured_us, 1e-9)
        self.metrics.histogram(
            "serve.round_residual", buckets=_RESIDUAL_BUCKETS
        ).observe(rel)
        record_event(
            "serve_round_measured",
            round=self.decode_steps,
            n_active=int(n_active),
            max_len=int(max_len),
            measured_us=round(measured_us, 3),
            predicted_us=round(predicted_us, 3),
            compute_us=round(pred["compute_us"], 3),
            bytes_us=round(pred["bytes_us"], 3),
        )

    def _cost_params(self):
        if self._cost_params_cache is None:
            from ..planner.calibrate import default_params

            self._cost_params_cache = default_params()
        return self._cost_params_cache

    def _predict_prefill_us(self, prompt_len: int, cached: int = 0) -> float:
        from .costs import predict_prefill_us

        return round(predict_prefill_us(
            self.cfg, prompt_len, self._cost_params(), cached_tokens=cached,
            device=self.device,
        ), 3)

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

    # ---- prefill/decode disaggregation -------------------------------------

    def prefill_for_migration(self, request: Request, codec: str = "f32"):
        """The prefill replica's half of a migration: run the prompt's
        prefill, emit the first token (greedy — the RPC tier carries no
        sampling knobs), and pack the sequence's KV blocks for the wire.

        The blocks stay allocated under ``_exported[rid]`` until
        :meth:`release_exported` — releasing before the decode side
        confirms admission would let a concurrent prefill recycle them
        while their bytes are the only copy of this sequence's state.
        The export moves to the host once, as float32 (exact for a
        bfloat16 pool).  Returns ``None`` when the pool cannot hold the
        prompt right now; raises :class:`MigrationError` for a request
        that could never migrate (oversized, sampled)."""
        req = request
        if req.temperature > 0:
            raise MigrationError(
                f"request {req.rid}: migration is greedy-only "
                f"(temperature={req.temperature})"
            )
        if req.prompt_len < 1 or req.prompt_len >= self.pcfg.max_len:
            raise MigrationError(
                f"request {req.rid}: prompt_len {req.prompt_len} outside "
                f"(0, max_len={self.pcfg.max_len})"
            )
        if req.rid in self._exported:
            raise MigrationError(
                f"request {req.rid}: migration already in flight"
            )
        n = self.pcfg.blocks_for(req.prompt_len)
        t0 = _now()
        try:
            blocks = self.batcher._alloc_with_evict(n)
        except CacheExhausted:
            self.metrics.counter("serve.migration_export_blocked").inc()
            return None
        record_event(
            "serve_admit", rid=req.rid, slot=-1,
            prompt_len=req.prompt_len, blocks=n, migration=True,
        )
        logits, cache = prefill(self.params, self._tokens(req.prompt)[None],
                                self.cfg, self.pcfg.max_len)
        write_prefill(self.pools, cache, blocks)
        if self.chaos_prefill_sleep_s > 0:
            time.sleep(self.chaos_prefill_sleep_s * req.prompt_len)
        first_token = int(np.argmax(logits[0].cpu().numpy()))
        kv = export_blocks(self.pools, blocks)
        layers = self.cfg.n_layers
        host = torch.stack(kv["k"] + kv["v"]).float().cpu().numpy()
        meta, blob = pack_kv({"k": list(host[:layers]),
                              "v": list(host[layers:])}, codec=codec)
        self._exported[req.rid] = blocks
        now = _now()
        self.metrics.counter("serve.migration_exports").inc()
        self.metrics.histogram(
            "serve.migration_bytes", buckets=_MIGRATION_BYTES_BUCKETS
        ).observe(len(blob))
        self.metrics.histogram("serve.ttft_ms").observe(
            (now - req.arrival_s) * 1e3
        )
        record_event(
            "serve_prefill", rid=req.rid, slot=-1,
            prompt_len=req.prompt_len, cached_tokens=0,
            measured_us=round((now - t0) * 1e6, 3),
            predicted_us=self._predict_prefill_us(req.prompt_len),
        )
        return {
            "first_token": first_token,
            "meta": meta,
            "blob": blob,
            "ttft_s": now - req.arrival_s,
            "prefill_s": now - t0,
        }

    def release_exported(self, rid: int, acked: bool) -> bool:
        """Drop the blocks held for ``rid``'s migration export — on the
        decode side's ack (the receiver owns a copy) or on the abort path
        (refused, timed out, receiver gone; the front door retries).
        Exactly one release per export, counted either way."""
        blocks = self._exported.pop(rid, None)
        if blocks is None:
            return False
        self.batcher.allocator.free(blocks)
        self.metrics.counter(
            "serve.migration_acked" if acked else "serve.migration_aborted"
        ).inc()
        if not acked:
            record_event("serve_migration_abort", rid=rid,
                         blocks=len(blocks))
        return True

    def admit_migrated(self, request: Request, first_token: int,
                       meta: dict, blob: bytes):
        """The decode replica's half: verify the payload, land the
        sequence.  :class:`MigrationError` for any integrity or geometry
        violation (CRC, shapes, a block count that does not match the
        prompt), ``None`` for a clean capacity refusal (no slot, no
        blocks, a resume backlog; the prefill side aborts and the front
        door retries).  On success the sequence is resident as if its
        prefill had run here — length = prompt_len, first token recorded
        — and decode continues from the imported blocks on the next
        :meth:`step`.  Returns the slot."""
        req = request
        total = req.prompt_len + req.max_new_tokens
        if req.prompt_len < 1 or total > self.pcfg.max_len:
            raise MigrationError(
                f"request {req.rid}: prompt+max_new {total} exceeds "
                f"max_len {self.pcfg.max_len}"
            )
        if self.pcfg.blocks_for(total) > self.pcfg.num_blocks - 1:
            raise MigrationError(
                f"request {req.rid}: needs {self.pcfg.blocks_for(total)} "
                f"blocks, pool holds {self.pcfg.num_blocks - 1}"
            )
        kv = unpack_kv(meta, blob)  # CRC + per-tensor verification
        if (
            int(meta["block_size"]) != self.pcfg.block_size
            or int(meta["n_heads"]) != self.cfg.n_heads
            or int(meta["head_dim"]) != self.cfg.head_dim
            or int(meta["n_layers"]) != self.cfg.n_layers
        ):
            raise MigrationError(
                f"request {req.rid}: payload geometry "
                f"(bs={meta['block_size']}, H={meta['n_heads']}, "
                f"Dh={meta['head_dim']}, L={meta['n_layers']}) does not "
                f"match this replica's model"
            )
        n_mig = int(meta["n_blocks"])
        if n_mig != self.pcfg.blocks_for(req.prompt_len):
            raise MigrationError(
                f"request {req.rid}: {n_mig} migrated blocks for a "
                f"{req.prompt_len}-token prompt "
                f"(expected {self.pcfg.blocks_for(req.prompt_len)})"
            )
        now = _now()
        admit = self.batcher.admit_migrated(req, first_token, now)
        if admit is None:
            self.metrics.counter("serve.migration_refused").inc()
            record_event(
                "serve_migration_refuse", rid=req.rid, reason="capacity"
            )
            return None
        slot, state = admit
        # one host-to-device copy of the whole payload; write_imported
        # casts each tensor to the pool's dtype
        layers = self.cfg.n_layers
        payload = torch.from_numpy(np.stack(kv["k"] + kv["v"])).to(
            self.device)
        write_imported(self.pools, {"k": list(payload[:layers]),
                                    "v": list(payload[layers:])},
                       state.block_ids[:n_mig])
        if self.batcher.prefix_index is not None:
            # the prompt's full blocks are shareable the moment they land:
            # the index adopts them at admission (the retirement insert
            # walks the same chain idempotently)
            full = req.prompt_len // self.pcfg.block_size
            self.batcher.prefix_index.insert(
                np.asarray(req.prompt), state.block_ids[:full]
            )
        self.metrics.counter("serve.migrations_in").inc()
        self.metrics.histogram(
            "serve.migration_bytes", buckets=_MIGRATION_BYTES_BUCKETS
        ).observe(len(blob))
        record_event(
            "serve_migration_recv", rid=req.rid, slot=slot,
            bytes=len(blob), codec=str(meta.get("codec")), blocks=n_mig,
        )
        return slot

    # ---- prefix-warm drain handoff -----------------------------------------

    def _block_hash(self, block: int) -> str:
        """CRC32 over a block's K and V bytes across every layer — the
        content witness a handoff successor checks its recomputed block
        against.  It holds within one package, device and dtype only:
        another matmul library gives other bits for the same prefix."""
        crc = 0
        for kind in ("k", "v"):
            for layer in self.pools[kind]:
                raw = layer[block].contiguous().view(torch.uint8)
                crc = zlib.crc32(raw.cpu().numpy().tobytes(), crc)
        return f"{crc & 0xFFFFFFFF:08x}"

    def export_prefix_handoff(self) -> dict | None:
        """Serialize the prefix index for a drain handoff: every node as
        its root-to-node token prefix plus the content hash of its block.
        Token ids and hashes travel; block ids and raw K/V never do — the
        successor recomputes each block from the prefix and uses the hash
        to prove it rebuilt the same bytes.  ``None`` when the prefix
        cache is disabled."""
        idx = self.batcher.prefix_index
        if idx is None:
            return None
        entries = [
            {
                "prefix": [int(t) for key in path for t in key],
                "hash": self._block_hash(block),
            }
            for path, block in idx.node_paths()
        ]
        self.metrics.counter("serve.handoff_exported_blocks").inc(
            len(entries)
        )
        record_event("serve_handoff_export", entries=len(entries))
        return {
            "version": 1,
            "block_size": self.pcfg.block_size,
            "entries": entries,
        }

    def prewarm_prefix_from_handoff(self, doc) -> dict:
        """Rebuild a predecessor's prefix cache from its handoff export:
        recompute each prefix's last block via prefill, verify the bytes
        against the recorded content hash, and adopt verified blocks into
        this replica's index before traffic arrives.  A hash mismatch
        refuses that entry (and, since children need their parent chain,
        its whole subtree) — a corrupt handoff degrades to a cold start,
        never to serving wrong K/V.  Returns stats counters."""
        stats = {"inserted": 0, "skipped": 0, "hash_mismatches": 0,
                 "refused": None}
        idx = self.batcher.prefix_index
        if idx is None:
            stats["refused"] = "prefix cache disabled"
            return stats
        bs = self.pcfg.block_size
        if (
            not isinstance(doc, dict)
            or doc.get("version") != 1
            or int(doc.get("block_size", -1)) != bs
            or not isinstance(doc.get("entries"), list)
        ):
            stats["refused"] = "incompatible handoff payload"
            self.metrics.counter("serve.handoff_refused").inc()
            record_event("serve_handoff_refused",
                         reason=stats["refused"])
            return stats
        alloc = self.batcher.allocator
        # parents sort before their children (tuple-prefix order), so one
        # pass builds chains bottom-up; keep one sequence's worth of
        # blocks free so prewarming can never starve first admission
        reserve = self.pcfg.blocks_per_seq
        for e in sorted(doc["entries"], key=lambda e: len(e["prefix"])):
            prefix = e.get("prefix")
            if (
                not isinstance(prefix, list) or not prefix
                or len(prefix) % bs != 0
            ):
                stats["skipped"] += 1
                continue
            tokens = np.asarray(prefix, np.int32)
            n = len(prefix) // bs
            matched = idx.match(tokens)
            if len(matched) >= n:
                continue  # already warm (shared parent of two subtrees)
            if len(matched) < n - 1:
                stats["skipped"] += 1  # parent refused/missing upstream
                continue
            if alloc.num_free <= reserve:
                stats["skipped"] += 1
                continue
            [b] = alloc.alloc(1)
            _, cache = prefill(self.params, self._tokens(tokens)[None],
                               self.cfg, self.pcfg.max_len)
            write_prefill_at(self.pools, cache, [b], n - 1)
            want = e.get("hash")
            if want is not None and self._block_hash(b) != want:
                alloc.release([b])
                stats["hash_mismatches"] += 1
                self.metrics.counter("serve.handoff_hash_mismatch").inc()
                record_event(
                    "serve_handoff_hash_mismatch", prefix_len=len(prefix)
                )
                continue
            idx.insert(tokens, matched + [b])
            alloc.release([b])  # the index's retain is now the holder
            stats["inserted"] += 1
        self.metrics.counter("serve.handoff_prewarmed_blocks").inc(
            stats["inserted"]
        )
        record_event("serve_handoff_prewarm", **stats)
        return stats

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
        if self.chaos_prefill_sleep_s > 0:
            # per computed token: a prefix-cache hit only pays its suffix
            time.sleep(self.chaos_prefill_sleep_s * (req.prompt_len - c))
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
            predicted_us=self._predict_prefill_us(req.prompt_len, c),
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

    def warmup(self, prompt_lens=(), block_counts=(), suffix_buckets=(),
               import_counts=()) -> None:
        """Launch, before a timed run, the work the requests will launch,
        so first-call set-up (kernel build and load, library handles,
        allocator growth) lands outside the first requests' latency: one
        decode round over all-inactive slots, one prefill for each
        distinct prompt length, one suffix prefill for each ``(cached_len,
        suffix_len)`` pair, and one pool write for each distinct block
        count (prefill reservations ``block_counts``, migrated imports
        ``import_counts``).  The JAX engine's signature; the model runs
        eagerly, so nothing compiles and each piece only launches.  Every
        write goes to the null block, as every inactive slot's does."""
        S, P = self.bcfg.slots, self.pcfg.blocks_per_seq
        dev = self.device
        zeros = torch.zeros(S, dtype=torch.int32, device=dev)
        self._decode(
            self.params, self.pools,
            torch.zeros((S, P), dtype=torch.int32, device=dev),
            zeros, zeros,
        )
        cache = None
        for t in sorted({int(t) for t in prompt_lens}):
            _, cache = prefill(self.params,
                               torch.zeros((1, t), dtype=torch.long,
                                           device=dev),
                               self.cfg, self.pcfg.max_len)
        for n in sorted({int(n) for n in block_counts}):
            if cache is None:
                _, cache = prefill(self.params,
                                   torch.zeros((1, 1), dtype=torch.long,
                                               device=dev),
                                   self.cfg, self.pcfg.max_len)
            write_prefill(self.pools, cache, [NULL_BLOCK] * n)
        shape = (self.pcfg.block_size, self.cfg.n_heads, self.cfg.head_dim)
        for n in sorted({int(n) for n in import_counts}):
            blank = [torch.zeros((n, *shape), dtype=self.cfg.dtype,
                                 device=dev)] * self.cfg.n_layers
            write_imported(self.pools, {"k": blank, "v": blank},
                           [NULL_BLOCK] * n)
        bs = self.pcfg.block_size
        for c, t in sorted({(int(c), int(t)) for c, t in suffix_buckets}):
            if c < 1 or t < 1:
                raise ValueError(
                    f"suffix bucket ({c}, {t}): cached_len and "
                    f"suffix_len must both be >= 1"
                )
            view = gather_seq(self.pools, [NULL_BLOCK] * -(-c // bs),
                              length=c)
            prefill_suffix(
                self.params,
                torch.zeros((1, t), dtype=torch.long, device=dev),
                {kind: [x[None] for x in view[kind]] for kind in ("k", "v")},
                self.cfg, self.pcfg.max_len,
            )
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
