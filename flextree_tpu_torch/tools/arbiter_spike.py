"""Arbiter spike: one elastic device pool under an injected arrival burst.

    python -m flextree_tpu_torch.tools.arbiter_spike [--smoke] [--out PATH]
    python -m flextree_tpu_torch.tools.arbiter_spike --device cpu --smoke

The port's counterpart of the JAX package's ``tools/arbiter_spike.py``.
One process, one chip inventory of four logical chips, two tenants
sharing it live:

- **training**: the ZeRO-1 sharded dense step on an in-process dp-3 mesh
  (chips 0-2), run by ``fit(arbiter=TrainLeaseClient(...))`` on its own
  thread with consolidated checkpoints;
- **serving**: a :class:`~flextree_tpu_torch.serving.ReplicaPool` with
  one baseline replica (chip 3) and two pre-warmed burst engines, fed
  open-loop arrivals;
- **the arbiter**: a :class:`~flextree_tpu_torch.arbiter.PoolArbiter`
  ticking between pool rounds, reading the pool's windowed TTFT p99
  against the SLO and moving chips through the lease ledger.

On one device the inventory's chips are logical slots — training's
in-process mesh ranks and the pool's replicas — as the JAX tool's are
virtual CPU devices.  The traffic has three phases: baseline, a Poisson
burst, baseline again until everything drains.  The rates and the SLO
come from what the device does in this run: while training
runs, the baseline replica alone serves a saturating batch, which gives
its capacity ``c`` (requests a second) and its service time; the
baseline rate is ``c / 4``, the burst ``1.7 c`` (the JAX tool's ratios)
and the SLO one service time of a request: a first token later than
that means the request queued longer than a whole request takes.  Each
phase holds its mean count of arrivals, ``round(rate * duration)``,
drawn uniformly over the phase (a Poisson process's arrival times given
their number): the phase's own rate, not a draw that may fall a quarter
short of it, is what the burst puts on the replica.

The expected story, each step checked from what the run leaves (the
arbiter's decisions, ``RunReport.lease_epochs``, the pool's report, the
merged flight-record timeline): the burst breaches the windowed SLO, the
arbiter revokes two chips, training checkpoints, shrinks dp-3 → dp-1
(a bitwise resume) and acks, the chips go to serving and the two warmed
replicas join (``slo_breach`` → ``lease_preempt`` → ``lease_grant``);
once the backlog drains and the window clears past the cooldown, the
burst replicas drain, the chips return (``lease_return``) and training
expands dp-1 → dp-3 (a bitwise resume again).

Exit 1 on any floor violation.  ``--smoke`` shortens the phases and
waives the two timing floors (recovery within one window, the step time
restored), as the JAX tool does; the structural floors — the arbiter
acted, every resize's resume bitwise, the chips came back, every request
served exactly once, a valid merged timeline — hold in both modes.
Results go to ``--out`` (default ``tmp/arbiter_spike.json``), which must
lie under ``tmp/``.
"""

from __future__ import annotations

import argparse
import collections
import dataclasses
import datetime
import json
import os
import sys
import tempfile
import threading
import time

import numpy as np

from ..serving.batcher import Request
from ..serving.workload import OUT_LENS, OUT_PROBS, PROMPT_LENS
from . import checked_out

_now = time.monotonic

#: the JAX tool's traffic ratios: the baseline at a quarter of one
#: replica's capacity, the burst at 1.7 times it
BASE_FRAC, SPIKE_FRAC = 0.25, 1.7
#: the capacity probe's batch, in slots: every slot busy for 2 slots'
#: worth of completions between the ramp-up and the ramp-down
CAPACITY_BATCH = 4
#: the JAX tool's timing floors: p99 back inside the SLO within one
#: window of max(first grant, burst end); the post-reclaim step time
#: within this factor of the pre-burst one
RECOVERY_WINDOWS = 1.0
STEP_RATIO_FLOOR = 1.5
#: the JAX tool's inventory: training holds chips 0-2 (dp-3), chip 3
#: is serving's baseline, a burst moves two
CHIPS = (0, 1, 2, 3)
TRAIN_CHIPS = (0, 1, 2)
BURST_CHIPS = 2
#: the engines' TTFT window and the arbiter's (the JAX tool's), and the
#: arbiter's tick between pool rounds
WINDOW_S = 6.0
TICK_S = 0.4


@dataclasses.dataclass(frozen=True)
class SpikeConfig:
    """One spike run.  ``train_model``/``serve_model``: the two tenants'
    ``TransformerConfig`` fields (serving in float32, so the pool's
    greedy tokens can be held against one engine's); ``train_batch`` rows
    divide by every training world (3 and 1); ``train_pace_s`` paces the
    trainer's steps outside its timed section."""

    device: str | None = None
    smoke: bool = False
    seed: int = 13
    train_model: dict = dataclasses.field(default_factory=lambda: dict(
        vocab_size=128, d_model=128, n_heads=4, n_layers=2, d_ff=512))
    train_dtype: str = "float32"
    train_attn: str = "reference"
    train_batch: int = 6
    train_seq: int = 32
    serve_model: dict = dataclasses.field(default_factory=lambda: dict(
        vocab_size=128, d_model=256, n_heads=8, n_layers=4, d_ff=1024))
    cache: dict = dataclasses.field(default_factory=lambda: dict(
        num_blocks=17, block_size=8, blocks_per_seq=8))
    slots: int = 2
    phases: tuple = (10.0, 12.0, 4.0)
    post_steps: int = 12
    train_pace_s: float = 0.03
    deadline_s: float = 240.0


def smoke_config(cfg: SpikeConfig) -> SpikeConfig:
    """The JAX tool's ``--smoke`` phases on ``cfg``."""
    return dataclasses.replace(cfg, smoke=True, phases=(4.0, 5.0, 3.0),
                               post_steps=4, deadline_s=90.0)


def _dtype(name: str):
    import torch

    return {"float32": torch.float32, "bfloat16": torch.bfloat16}[name]


class _LMData:
    def __init__(self, batch: int, seq: int, vocab: int):
        self.batch, self.seq, self.vocab = batch, seq, vocab

    def batch_at(self, step):
        tok = (np.arange(self.batch * self.seq, dtype=np.int32).reshape(
            self.batch, self.seq) + step) % self.vocab
        return tok, tok


class TrainWorlds:
    """The sharded training world a chip count, built once and kept, so a
    lease resize swaps to a built step.  Each step waits for the device
    and lands in :attr:`step_trace` as ``(wall, seconds, world)``."""

    def __init__(self, cfg: SpikeConfig, dev):
        import torch

        from ..models.transformer import (
            TransformerConfig,
            init_params,
            param_specs,
        )
        from ..parallel import train as tm

        self.dev = dev
        self.cfg = cfg
        self.model_cfg = TransformerConfig(**cfg.train_model,
                                           dtype=_dtype(cfg.train_dtype),
                                           attn_impl=cfg.train_attn)
        self.base_tc = tm.TrainConfig(shard_optimizer=True)
        self.pspecs = param_specs(self.model_cfg)
        self.shapes = init_params(self.model_cfg,
                                  torch.Generator().manual_seed(0),
                                  device="cpu")
        #: the bytes a step syncs (the float32 gradient): prices replans
        self.nbytes = sum(t.numel() * t.element_size()
                          for t in tm.tree_leaves(self.shapes))
        self._cache: dict = {}
        self.step_trace: list = []
        self.tracing = True

    def build(self, ndev: int, grad_topo=None):
        """``(step_fn, comm, None, pack, unpack)``: the 5-tuple
        ``on_resize`` returns."""
        key = (ndev, grad_topo)
        if key in self._cache:
            return self._cache[key]
        import torch

        from ..parallel import train as tm
        from ..parallel.mesh import flat_mesh
        from ..parallel.zero import make_consolidate_fn, make_reshard_fn

        tc = dataclasses.replace(self.base_tc, grad_topo=grad_topo)
        comm = flat_mesh(ndev, self.dev, "dp")
        inner = tm.make_train_step(self.model_cfg, tc, comm=comm)
        layout = tm.zero_layout_for(comm, self.shapes, self.pspecs)
        trace, dev, pace = self.step_trace, self.dev, self.cfg.train_pace_s

        def step_fn(state, tokens, targets):
            t0 = _now()
            out = inner(state, tokens, targets)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            if self.tracing:
                trace.append((time.time(), _now() - t0, ndev))
            if pace:
                time.sleep(pace)  # outside the timed section
            return out

        built = (step_fn, comm, None,
                 make_consolidate_fn(comm, self.pspecs, layout, grad_topo,
                                     False),
                 make_reshard_fn(comm, self.pspecs, layout, grad_topo, False))
        self._cache[key] = built
        return built

    def initial_state(self, ndev: int, grad_topo=None):
        import torch

        from ..parallel import train as tm

        _, comm, _, _, _ = self.build(ndev, grad_topo)
        return tm.init_train_state(
            self.model_cfg, torch.Generator().manual_seed(self.cfg.seed),
            self.base_tc, device=self.dev, comm=comm)

    def warm(self, ndev: int, grad_topo=None) -> None:
        """One step and one pack/unpack of the world, off the record."""
        step_fn, _, _, pack, unpack = self.build(ndev, grad_topo)
        state = self.initial_state(ndev, grad_topo)
        tok, tgt = _LMData(self.cfg.train_batch, self.cfg.train_seq,
                           self.cfg.train_model["vocab_size"]).batch_at(0)
        self.tracing = False
        try:
            unpack(pack(step_fn(state, tok, tgt)[0]))
        finally:
            self.tracing = True


def start_trainer(worlds: TrainWorlds, client, ckpt_dir: str, guard,
                  plans: dict, cfg: SpikeConfig):
    """Run ``fit`` on a daemon thread; returns (thread, result_holder)."""
    from ..parallel.loop import FitConfig, Supervision, fit

    holder: dict = {}
    client.on_resize = lambda chips, plan: worlds.build(len(chips),
                                                        plan.to_ft_topo())
    n0 = len(TRAIN_CHIPS)
    step0, _, _, pack0, unpack0 = worlds.build(n0, plans[n0])
    state0 = worlds.initial_state(n0, plans[n0])
    data = _LMData(cfg.train_batch, cfg.train_seq,
                   cfg.train_model["vocab_size"])

    def run():
        try:
            holder["result"] = fit(
                state0, step0, data,
                FitConfig(num_steps=1_000_000, ckpt_dir=ckpt_dir,
                          ckpt_every=1_000_000, log_every=0, prefetch=0),
                supervision=Supervision(preemption=guard), arbiter=client,
                state_pack=pack0, state_unpack=unpack0)
        except Exception as e:  # a floor violation, reported by the caller
            holder["error"] = f"{type(e).__name__}: {e}"

    thread = threading.Thread(target=run, daemon=True, name="ft-trainer")
    thread.start()
    return thread, holder


def _requests(cfg: SpikeConfig, rates, phases, seed):
    """Baseline, burst and tail arrivals, each phase ``round(rate *
    duration)`` of them, sorted uniform draws over the phase; prompts and
    output lengths drawn as ``serving.workload``'s.  Returns ``(requests,
    spike_start_s, spike_end_s)``."""
    rng = np.random.default_rng(seed)
    starts = np.cumsum((0.0,) + tuple(phases))
    arrivals = np.concatenate([
        np.sort(t0 + rng.uniform(0.0, dur, int(round(rate * dur))))
        for t0, dur, rate in zip(starts, phases,
                                 (rates[0], rates[1], rates[0]))])
    requests = []
    for i, a in enumerate(arrivals):
        p = int(rng.choice(PROMPT_LENS))
        m = int(rng.choice(OUT_LENS, p=OUT_PROBS))
        prompt = rng.integers(0, cfg.serve_model["vocab_size"],
                              (p,)).astype(np.int32)
        requests.append(Request(rid=i, prompt=prompt, max_new_tokens=m,
                                arrival_s=float(a)))
    return requests, float(starts[1]), float(starts[2])


def measure_capacity(pool, cfg: SpikeConfig, reqs) -> dict:
    """One replica's capacity while training runs: a saturating batch of
    requests (the workload's mix) submitted at once to a one-replica
    ``pool`` of a warmed engine like the baseline's (its own, so the
    batch's queueing stays out of the run's TTFT windows), stepped to the
    end.  Returns requests a second over the stretch where every slot is
    busy (between the first ``slots`` completions and the last ``slots``:
    the ramp-down, with slots emptying, would understate the capacity a
    burst meets), the mean service time of a request and the TTFTs."""
    n = CAPACITY_BATCH * cfg.slots
    if len(reqs) < n:
        raise ValueError(f"{len(reqs)} requests for a batch of {n}")
    batch = [dataclasses.replace(r, arrival_s=0.0) for r in reqs[:n]]
    t0 = _now()
    for r in batch:
        pool.submit(r)  # arrival 0.0: the engine stamps its own clock
    while not pool.idle:
        pool.step()
    wall = _now() - t0
    done = [pool.completed.pop(r.rid) for r in batch]
    service = float(np.mean([d.done_s - d.first_token_s + d.ttft_s
                             for d in done[:cfg.slots]]))
    ends = sorted(d.done_s for d in done)
    k = cfg.slots
    steady = ends[n - k - 1] - ends[k - 1]
    return {"requests": n, "wall_s": wall,
            "rps": (n - 2 * k) / steady if steady > 0 else n / wall,
            "service_s": service,
            "ttft_ms": [round(d.ttft_s * 1e3, 3) for d in done]}


def run_spike(cfg: SpikeConfig, workdir: str, *, on_start=None,
              on_pool=None, log=print) -> dict:
    """One spike run in ``workdir``; returns the result document (with
    ``violations`` and ``ok``) and, under ``"_run"``, what a caller needs
    to check more (the worlds, the engines, the requests, the pool's
    completions, the arbiter).  ``on_pool(pool, engines)`` is called once
    the pool is up (the baseline engine first), ``on_start()`` once
    everything is built and warmed, just before the trainer starts."""
    import torch

    from ..arbiter import (
        ArbiterConfig,
        DeviceInventory,
        PoolArbiter,
        pool_slo_reader,
    )
    from ..device import resolve_device
    from ..models.transformer import TransformerConfig, init_params
    from ..planner.choose import replan_for_survivors
    from ..runtime import LeaseLedger, PreemptionGuard, TrainLeaseClient
    from ..serving import (
        BatcherConfig,
        PagedCacheConfig,
        PoolConfig,
        ReplicaPool,
        ServingEngine,
    )

    dev = resolve_device(cfg.device)
    hb_dir = os.path.join(workdir, "hb")  # heartbeats AND the lease ledger
    ckpt_dir = os.path.join(workdir, "ck")
    os.makedirs(hb_dir, exist_ok=True)
    n_train = len(TRAIN_CHIPS)

    # --- serving: the baseline replica and the pre-warmed burst engines
    scfg = TransformerConfig(**cfg.serve_model, dtype=torch.float32)
    sparams = init_params(scfg, torch.Generator().manual_seed(7), device=dev)
    pcfg = PagedCacheConfig(**cfg.cache)
    # the warm-up covers every prompt length and block count the mix can
    # draw, so no request meets a first launch
    warm = (sorted(PROMPT_LENS), sorted(
        {pcfg.blocks_for(p + o) for p in PROMPT_LENS for o in OUT_LENS}))

    def make_engine() -> ServingEngine:
        eng = ServingEngine(sparams, scfg, pcfg,
                            BatcherConfig(slots=cfg.slots),
                            slo_window_s=WINDOW_S, device=dev)
        eng.warmup(*warm)
        return eng

    baseline = make_engine()
    probe_engine = make_engine()  # the capacity measurement's own
    burst_engines = collections.deque(make_engine()
                                      for _ in range(BURST_CHIPS))
    # the baseline first; the probe's rounds launch on this path too
    engines = [baseline, *burst_engines, probe_engine]
    pool = ReplicaPool([baseline], PoolConfig(
        heartbeat_dir=hb_dir, interval_s=0.1, parallel_rounds=True))
    if on_pool is not None:
        on_pool(pool, engines)
    chip_to_replica: dict = {}

    def on_serve_grant(chips):
        for c in chips:
            chip_to_replica[c] = pool.add_replica(burst_engines.popleft())

    def on_serve_return(chips):
        for c in chips:
            pool.release_replica(chip_to_replica.pop(c))

    # --- training: the sharded worlds, built and warmed
    worlds = TrainWorlds(cfg, dev)
    plans = {n: replan_for_survivors(n, worlds.nbytes,
                                     configured=n_train).to_ft_topo()
             for n in (n_train, n_train - BURST_CHIPS)}
    for n, topo in plans.items():
        worlds.warm(n, topo)
    decode0 = [e.decode_steps for e in engines]
    if on_start is not None:
        on_start()

    ledger = LeaseLedger(hb_dir)
    client = TrainLeaseClient(ledger, initial_chips=TRAIN_CHIPS,
                              configured=n_train, nbytes_hint=worlds.nbytes,
                              poll_interval_s=0.1)
    # each resize's wall: from the poll that saw the grant to the ack
    resize_s: list = []
    seen_at: list = []
    poll, ack = client.poll, client.ack

    def timed_poll(step):
        d = poll(step)
        if d is not None:
            seen_at.append(_now())
        return d

    def timed_ack(directive):
        ack(directive)
        resize_s.append(_now() - seen_at[-1])

    client.poll, client.ack = timed_poll, timed_ack
    guard = PreemptionGuard()  # triggered in-process to stop the trainer
    trainer, holder = start_trainer(worlds, client, ckpt_dir, guard, plans,
                                    cfg)
    t_run0 = _now()
    try:
        # --- the rates and the SLO, from this run's device under training
        n_probe = CAPACITY_BATCH * cfg.slots
        probe_reqs, _, _ = _requests(cfg, (n_probe, 0.0), (1.0, 0.0, 0.0),
                                     cfg.seed + 1)
        with ReplicaPool([probe_engine], PoolConfig(
                heartbeat_dir=os.path.join(workdir, "hb_probe"),
                interval_s=0.1, parallel_rounds=True)) as probe_pool:
            cap = measure_capacity(probe_pool, cfg, probe_reqs)
        rates = BASE_FRAC * cap["rps"], SPIKE_FRAC * cap["rps"]
        slo = cap["service_s"] * 1e3
        log(f"capacity of one replica while training runs: "
            f"{cap['rps']:.2f} requests/s ({cap['requests']} at once in "
            f"{cap['wall_s']:.3f} s; service {cap['service_s'] * 1e3:.1f} "
            f"ms a request); rates {rates[0]:.2f} -> {rates[1]:.2f} -> "
            f"{rates[0]:.2f} requests/s, SLO p99 TTFT {slo:.1f} ms")
        acfg = ArbiterConfig(slo_p99_ms=slo, window_s=WINDOW_S,
                             release_frac=0.5, breach_ticks=2, clear_ticks=4,
                             cooldown_s=3.0, min_train_chips=1,
                             burst_chips=BURST_CHIPS, min_samples=6)
        requests, spike_start, spike_end = _requests(cfg, rates, cfg.phases,
                                                     cfg.seed)
        inventory = DeviceInventory(CHIPS, train=TRAIN_CHIPS)
        arbiter = PoolArbiter(
            inventory, ledger, acfg,
            slo_reader=pool_slo_reader(pool, window_s=acfg.window_s),
            on_serve_grant=on_serve_grant, on_serve_return=on_serve_return)

        # --- the run loop
        pending = collections.deque(sorted(requests,
                                           key=lambda r: r.arrival_s))
        t0 = _now()
        wall0 = time.time()
        last_tick = t0
        quiet_wall = None  # everything drained AND the chips home
        deadline = t0 + cfg.deadline_s
        while _now() < deadline:
            now = _now()
            rel = now - t0
            while pending and pending[0].arrival_s <= rel:
                req = pending.popleft()
                # the engines' clock is this module's monotonic one
                pool.submit(dataclasses.replace(req,
                                                arrival_s=t0 + req.arrival_s))
            if now - last_tick >= TICK_S:
                arbiter.tick()
                last_tick = now
            if not pool.idle:
                pool.step()
            else:
                time.sleep(0.02)
            if (not pending and pool.idle and not arbiter.loaned
                    and not arbiter.pending_handoff):
                # quiet (the traffic served and the chips home, or never
                # moved — the floors below say which): wait for
                # post_steps full-world steps past here
                if quiet_wall is None:
                    quiet_wall = time.time()
                post = [d for w, d, n in worlds.step_trace
                        if n == n_train and w > quiet_wall]
                if len(post) >= cfg.post_steps:
                    break
            else:
                quiet_wall = None
            if "error" in holder:
                break
        ran_out = _now() >= deadline
    finally:
        guard.trigger()
        trainer.join(timeout=300.0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
    run_s = _now() - t_run0
    result = holder.get("result")

    # --- the evidence
    decisions = list(arbiter.decisions)
    report = result.report if result is not None else None
    lease_epochs = list(report.lease_epochs) if report is not None else []
    pool_report = pool.report()
    completed = dict(pool.completed)
    pool.shutdown()

    def wall_of(action):
        return [d["wall"] for d in decisions if d["action"] == action]

    preempts, grants, returns = (wall_of("preempt"), wall_of("grant"),
                                 wall_of("return"))
    breaches = [d["wall"] for d in decisions if d["breached"]]
    spike_end_wall = wall0 + spike_end
    recovery_wall = None
    if grants:
        for d in decisions:
            p99 = d["reading"]["p99_ms"]
            if d["wall"] >= grants[0] and (d["reading"]["samples"] == 0 or (
                    p99 is not None and p99 <= acfg.slo_p99_ms)):
                recovery_wall = d["wall"]
                break
    recovery_ref = max(grants[0], spike_end_wall) if grants else None
    recovery_s = (None if recovery_wall is None or recovery_ref is None
                  else max(0.0, recovery_wall - recovery_ref))
    trace = list(worlds.step_trace)
    first_resize = min(preempts) if preempts else float("inf")
    post_ref = quiet_wall if quiet_wall is not None else float("inf")
    pre = [d for w, d, n in trace if n == n_train and w < first_resize]
    post = [d for w, d, n in trace if n == n_train and w > post_ref]
    pre_ms = float(np.median(pre)) * 1e3 if pre else None
    post_ms = float(np.median(post)) * 1e3 if post else None
    step_ratio = post_ms / pre_ms if pre_ms and post_ms else None

    def p99_in(lo, hi):
        vals = [d["reading"]["p99_ms"] for d in decisions
                if lo <= d["wall"] < hi and d["reading"]["p99_ms"]
                is not None]
        return max(vals) if vals else None

    submitted = pool_report["submitted"]
    served = sorted(completed)
    doc = {
        "smoke": cfg.smoke,
        "device": {"type": dev.type, "name": torch.cuda.get_device_name(dev)
                   if dev.type == "cuda" else "cpu"},
        "deviation": "the inventory's chips are logical slots of one "
                     "device: training's in-process mesh ranks and the "
                     "pool's replicas",
        "capacity": cap,
        "phases": {"baseline_s": cfg.phases[0], "spike_s": cfg.phases[1],
                   "tail_s": cfg.phases[2], "base_rate_rps": rates[0],
                   "spike_rate_rps": rates[1], "requests": len(requests)},
        "arbiter": {
            "slo_p99_ms": acfg.slo_p99_ms, "window_s": acfg.window_s,
            "release_frac": acfg.release_frac,
            "cooldown_s": acfg.cooldown_s, "ticks": len(decisions),
            "preempts": len(preempts), "grants": len(grants),
            "returns": len(returns),
            "final_train_chips": list(inventory.held_by("train")),
            "final_serve_chips": list(inventory.held_by("serve")),
            "loaned_at_end": list(arbiter.loaned),
            "breach_to_grant_s": (grants[0] - breaches[0]
                                  if grants and breaches else None),
        },
        "serving": {
            "submitted": submitted, "completed": len(served),
            "rejected": pool_report["rejected"],
            "reroutes": pool_report["reroutes"],
            "replicas": pool_report["replicas"],
            "released": pool_report["released"],
            "degraded": pool_report["degraded"],
            "p99_ms": {"before": p99_in(wall0, wall0 + spike_start),
                       "during": p99_in(wall0 + spike_start,
                                        spike_end_wall),
                       "after": p99_in(spike_end_wall, float("inf"))},
        },
        "training": {
            "error": holder.get("error"),
            "steps_run": result.steps_run if result else None,
            "final_step": int(result.state["step"]) if result else None,
            "anomalies": report.anomalies if report else None,
            "skipped_steps": list(report.skipped_steps) if report else None,
            "lease_epochs": lease_epochs,
            "resize_s": resize_s,
            "losses_finite": bool(result) and all(
                np.isfinite(v) for _, v in result.losses),
            "pre_spike_step_ms": pre_ms,
            "post_reclaim_step_ms": post_ms,
            "step_time_ratio": step_ratio,
            "steps_by_world": {str(n): sum(1 for _, _, w in trace if w == n)
                               for n in sorted({w for _, _, w in trace})},
        },
        "recovery": {
            "spike_end_wall": spike_end_wall,
            "first_grant_wall": grants[0] if grants else None,
            "recovery_wall": recovery_wall,
            "recovery_s_past_ref": recovery_s,
            "recovery_windows": (None if recovery_s is None
                                 else recovery_s / WINDOW_S),
        },
        "decisions": [
            {"t": round(d["wall"] - wall0, 3), "action": d["action"],
             "p99_ms": d["reading"]["p99_ms"],
             "samples": d["reading"]["samples"], "breached": d["breached"]}
            for i, d in enumerate(decisions)
            if d["action"] is not None
            or i % max(1, int(1.0 / TICK_S)) == 0],
        "run_s": run_s,
        "ran_out_of_time": ran_out,
    }

    violations: list = []

    def floor(ok: bool, what: str) -> None:
        if not ok:
            violations.append(what)

    floor(holder.get("error") is None, f"trainer died: {holder.get('error')}")
    floor(not ran_out, "run hit its wall-clock deadline before draining")
    floor(len(preempts) >= 1, "no lease_preempt: the burst never moved chips")
    floor(len(grants) >= 1, "no lease_grant: chips never reached serving")
    floor(len(returns) >= 1, "no lease_return: chips never came back")
    floor(tuple(inventory.held_by("train")) == TRAIN_CHIPS,
          f"training did not reclaim its chips: "
          f"{inventory.held_by('train')} != {TRAIN_CHIPS}")
    floor(not arbiter.loaned, f"chips still loaned: {arbiter.loaned}")
    floor([len(e["chips"]) for e in lease_epochs]
          == [n_train - BURST_CHIPS, n_train],
          f"expected the resizes {n_train} -> "
          f"{n_train - BURST_CHIPS} -> {n_train}, got {lease_epochs}")
    floor(all(e["bitwise_resume"] for e in lease_epochs),
          f"non-bitwise resume in lease epochs: {lease_epochs}")
    floor(report is not None and report.anomalies == 0
          and not report.skipped_steps, "training skipped steps")
    floor(doc["training"]["losses_finite"], "non-finite training loss")
    floor(served == sorted(r.rid for r in requests)
          and submitted == len(requests),
          f"served {len(served)}/{submitted} of {len(requests)} requests")
    floor(not pool_report["rejected"],
          f"rejected requests: {pool_report['rejected']}")
    if not cfg.smoke:
        floor(recovery_s is not None
              and recovery_s <= RECOVERY_WINDOWS * WINDOW_S,
              f"p99 did not recover within one window: {recovery_s}s > "
              f"{WINDOW_S}s")
        floor(step_ratio is not None and step_ratio <= STEP_RATIO_FLOOR,
              f"post-reclaim step time not restored: ratio {step_ratio}")
    doc["violations"] = violations
    doc["ok"] = not violations
    doc["_run"] = dict(worlds=worlds, engines=engines, requests=requests,
                       completed=completed, decode0=decode0,
                       arbiter=arbiter, plans=plans, report=report,
                       scfg=scfg, sparams=sparams, pcfg=pcfg, acfg=acfg)
    return doc


def check_timeline(doc: dict, obs_dir: str) -> None:
    """The merged timeline of the run's flight record: valid, with the
    arbiter's events on their lane and the train and serve spans they
    caused.  Adds to ``doc["violations"]``."""
    from ..obs.timeline import merge_dir, read_dir, validate_trace

    trace = merge_dir(obs_dir)
    bad = validate_trace(trace)
    events = read_dir(obs_dir)[0]
    kinds = {e["kind"] for e in events}
    need = {"slo_breach", "lease_preempt", "lease_grant", "lease_return",
            "lease_resize", "step_start", "serve_admit"}
    missing = sorted(need - kinds)
    lane = [e["name"] for e in trace.get("traceEvents", ())
            if e.get("ph") == "i" and e.get("tid") == 2]
    order = [k for k in (e["kind"] for e in events)
             if k in ("slo_breach", "lease_preempt", "lease_grant",
                      "lease_return")]
    doc["timeline"] = {"events": len(trace.get("traceEvents", ())),
                       "schema_violations": bad, "missing_kinds": missing,
                       "arbiter_lane": len(lane),
                       "arbiter_order": order}
    if bad:
        doc["violations"].append(f"timeline schema violations: {bad[:5]}")
    if missing:
        doc["violations"].append(f"timeline missing kinds: {missing}")
    # after the initial grant: the first of each in the story's order
    seq = ["slo_breach", "lease_preempt", "lease_grant", "lease_return"]
    idx = [order.index(k, 1) if k in order[1:] else None for k in seq]
    if None in idx or idx != sorted(idx) or not lane:
        doc["violations"].append(
            f"arbiter events out of order or off their lane: {order}, "
            f"{len(lane)} on the lane")
    doc["ok"] = not doc["violations"]


def parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join("tmp", "arbiter_spike.json"))
    ap.add_argument("--timeline-out", default=None,
                    help="also write the merged Chrome trace here (under "
                    "tmp/)")
    ap.add_argument("--smoke", action="store_true",
                    help="short phases; waive the timing floors")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    return ap


def main(argv=None) -> int:
    ap = parser()
    args = ap.parse_args(argv)
    out = checked_out(ap, args.out)
    tl_out = (checked_out(ap, args.timeline_out) if args.timeline_out
              else None)
    from ..obs import flight_recorder
    from ..obs.timeline import merge_dir, write_trace

    cfg = SpikeConfig(device=args.device)
    if args.smoke:
        cfg = smoke_config(cfg)
    with tempfile.TemporaryDirectory(prefix="ft-arbiter-spike-") as wd:
        obs_dir = os.path.join(wd, "obs")
        with flight_recorder(obs_dir, rank=0):
            doc = run_spike(cfg, wd)
        doc.pop("_run")
        check_timeline(doc, obs_dir)
        if tl_out:
            write_trace(merge_dir(obs_dir), tl_out)
    doc["finished"] = datetime.datetime.now(datetime.timezone.utc) \
        .isoformat(timespec="seconds")
    with open(out, "w") as f:
        json.dump(doc, f, indent=2, sort_keys=True, default=str)
    print(f"wrote {out} (ok={doc['ok']})")
    for v in doc["violations"]:
        print(f"VIOLATION: {v}", file=sys.stderr)
    return 0 if doc["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
