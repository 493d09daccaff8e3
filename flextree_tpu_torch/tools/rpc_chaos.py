"""Executed kill chaos for the real-process serving front door.

    python -m flextree_tpu_torch.tools.rpc_chaos [--smoke] [--out PATH]
    python -m flextree_tpu_torch.tools.rpc_chaos --device cpu --only torn

The port's counterpart of the JAX package's ``tools/rpc_chaos.py``
(``serving/rpc.py``, ``serving/replica_main.py`` and
``serving/frontdoor.py``).  Every scenario spawns real replica processes
(``python -m flextree_tpu_torch.serving.replica_main``, given ``--cpu``
on the CPU, decoding in float32 on the paged kernel on a card, its plain
stream on the CPU), drives them through a real :class:`FrontDoor` over TCP, and
injects a real fault:

- ``sigkill`` (``sigkill_mid_decode``): SIGKILL a replica while it
  decodes; every request completes exactly once on the survivor, with
  the retries counted and no duplicate delivery;
- ``drain`` (``graceful_drain``): SIGTERM a replica mid-run; it refuses
  its in-flight work loudly (``drain`` responses the front door
  re-routes), flushes its record and exits 0;
- ``sigstop`` (``sigstop_straggler_hedged``): SIGSTOP a replica holding
  requests; windowed-p99 hedging routes duplicates around it and beats a
  no-hedge twin's p99 TTFT on the same workload and stall, the replica's
  idempotency store keeping the race exactly-once;
- ``torn`` (``torn_frames``): the replica flips a byte inside every 3rd
  response frame (``FT_RPC_TEAR_EVERY``); every tear is caught by the CRC
  trailer, retried and answered from the idempotency store;
- ``spike`` (``poisson_spike``): an open-loop burst far above the intake
  bound; every rid is exactly one of completed / shed / failed, with a
  ``serve_shed`` event a shed rid and the ``serve.shed`` counter agreeing.

Every result's tokens are held bitwise to the oracle, as the JAX tool
holds them: the port's single-process ``generate`` (contiguous cache,
greedy, float32) on the replicas' weights from the same seed, in this
process.  The model is the JAX tool's tiny one on the CPU and the
flagship width on a card (:func:`model_args`).  Every floor is checked;
exit 1 on any violation.  ``--smoke`` runs :data:`SMOKE`.  Results go to
``--out`` (default ``tmp/rpc_chaos.json``), under ``tmp/``.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import signal
import subprocess
import sys
import tempfile
import time

import numpy as np

from . import FLAGSHIP, checked_out

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))

#: the JAX tool's model (``tools/rpc_chaos.py``), for the CPU
MODEL_ARGS = ["--vocab", "64", "--d-model", "32", "--n-heads", "2",
              "--n-layers", "1", "--d-ff", "64", "--seed", "0"]
#: the flagship (``tools.FLAGSHIP``), for a card
FLAGSHIP_ARGS = ["--vocab", str(FLAGSHIP["vocab_size"]),
                 "--d-model", str(FLAGSHIP["d_model"]),
                 "--n-heads", str(FLAGSHIP["n_heads"]),
                 "--n-layers", str(FLAGSHIP["n_layers"]),
                 "--d-ff", str(FLAGSHIP["d_ff"]), "--seed", "0"]
PROMPT_LENS = (4, 6, 8)
MAX_NEW = (8, 16)
#: the replica's default paged cache and slots (``replica_main``)
CACHE = dict(num_blocks=65, block_size=8, blocks_per_seq=10)
MAX_LEN = CACHE["block_size"] * CACHE["blocks_per_seq"]  # a sequence's room
SLOTS = 4
READY_TIMEOUT_S = 180.0
RUN_TIMEOUT_S = 120.0


def model_args(device: str) -> list:
    """The replicas' model flags: the flagship on a card, the JAX tool's
    tiny model on the CPU."""
    return list(FLAGSHIP_ARGS if device.startswith("cuda") else MODEL_ARGS)


def _model_config(args: list):
    from ..models.transformer import TransformerConfig

    kv = dict(zip(args[::2], args[1::2]))
    return TransformerConfig(
        vocab_size=int(kv["--vocab"]), d_model=int(kv["--d-model"]),
        n_heads=int(kv["--n-heads"]), n_layers=int(kv["--n-layers"]),
        d_ff=int(kv["--d-ff"])), int(kv["--seed"])


# --------------------------------------------------------------------------
# workload + oracle
# --------------------------------------------------------------------------


def build_requests(seed: int, n: int, max_new=MAX_NEW) -> list:
    """The deterministic request mix: the front door and the oracle both
    derive it from the seed."""
    rng = np.random.default_rng(seed)
    out = []
    for i in range(n):
        t = int(rng.choice(PROMPT_LENS))
        out.append({"rid": i,
                    "prompt": rng.integers(0, 64, (t,)).astype(np.int32),
                    "max_new": int(rng.choice(max_new))})
    return out


class Oracle:
    """``generate`` (contiguous cache, single process, greedy, float32)
    per request with the replicas' model and seed, in this process on
    ``device``: the ground truth every chaotic run's tokens must match
    bitwise.  It shares the weights and no serving code with the
    replicas: no batcher, paging, slots or paged kernel."""

    def __init__(self, device: str):
        import torch

        from ..models.transformer import init_params

        self.device = device
        cfg, seed = _model_config(model_args(device))
        self.cfg = cfg
        self.params = init_params(cfg, torch.Generator().manual_seed(seed),
                                  device=device)
        self._cache: dict = {}

    def tokens(self, req: dict) -> np.ndarray:
        key = (req["prompt"].tobytes(), req["max_new"])
        if key not in self._cache:
            import torch

            from ..models.generate import generate

            prompt = torch.as_tensor(req["prompt"], device=self.device)
            self._cache[key] = generate(
                self.params, prompt[None], self.cfg,
                max_new_tokens=req["max_new"], max_len=MAX_LEN,
            )[0].cpu().numpy().astype(np.int32)
        return self._cache[key]


def bitwise_violations(fd, requests, oracle: Oracle) -> list:
    bad = []
    for req in requests:
        res = fd.completed.get(req["rid"])
        if res is not None and not np.array_equal(
                np.asarray(res.tokens, np.int32), oracle.tokens(req)):
            bad.append(req["rid"])
    return bad


# --------------------------------------------------------------------------
# replica processes
# --------------------------------------------------------------------------


def spawn_replica(ctrl: str, rank: int, device: str, extra_env=None,
                  extra_args=(), max_pending: int = 64,
                  warm_lens=PROMPT_LENS, warm_max_new: int = max(MAX_NEW),
                  suffix_lens: str = "") -> subprocess.Popen:
    """``python -m flextree_tpu_torch.serving.replica_main`` on
    ``device`` with the model of :func:`model_args`, warmed for
    ``warm_lens``; one torch thread."""
    cmd = [sys.executable, "-m", "flextree_tpu_torch.serving.replica_main",
           "--rank", str(rank), "--dir", ctrl,
           *(["--cpu"] if device == "cpu" else []),
           "--max-pending", str(max_pending),
           "--warmup-prompt-lens", ",".join(str(t) for t in warm_lens),
           "--warmup-max-new", str(warm_max_new),
           *model_args(device), *extra_args]
    if suffix_lens:
        cmd += ["--warmup-suffix-lens", suffix_lens]
    path = os.environ.get("PYTHONPATH")
    return subprocess.Popen(
        cmd, cwd=ROOT,
        env={**os.environ, "OMP_NUM_THREADS": "1",
             "PYTHONPATH": ROOT + (os.pathsep + path if path else ""),
             **(extra_env or {})},
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)


def wait_ready(ctrl: str, ranks, procs=None) -> None:
    """Block until every replica's endpoint answers a ping (the endpoint
    file lands before the warmup ends, so the file alone is not
    readiness)."""
    from ..runtime.ctrlfile import read_control_json
    from ..serving.rpc import RpcConnection, RpcError

    deadline = time.time() + READY_TIMEOUT_S
    for rank in ranks:
        path = os.path.join(ctrl, f"rpc_{rank:05d}.json")
        while True:
            if time.time() >= deadline:
                raise TimeoutError(f"replica {rank} never became ready")
            if procs and procs[rank].poll() is not None:
                raise RuntimeError(f"replica {rank} exited with "
                                   f"{procs[rank].returncode} before it "
                                   f"was ready: {log_tail(procs[rank])}")
            ep = read_control_json(path)
            if ep is not None:
                try:
                    conn = RpcConnection.connect(ep["host"], int(ep["port"]),
                                                 timeout_s=1.0)
                    try:
                        ok = conn.call({"kind": "ping"},
                                       timeout_s=2.0).get("ok")
                    finally:
                        conn.close()
                    if ok:
                        break
                except RpcError:
                    pass
            time.sleep(0.2)


def shutdown(procs: dict) -> dict:
    """SIGTERM every live replica (the drain path), SIGKILL after 20 s;
    ``{rank: returncode}``."""
    rcs = {}
    for proc in procs.values():
        if proc.poll() is None:
            try:
                os.kill(proc.pid, signal.SIGCONT)
                proc.send_signal(signal.SIGTERM)
            except OSError:
                pass
    for rank, proc in procs.items():
        try:
            proc.wait(timeout=20.0)
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
        rcs[rank] = proc.returncode
        if proc.stdout is not None:
            proc.stdout.close()
    return rcs


def log_tail(proc: subprocess.Popen, n: int = 8) -> list:
    if proc.poll() is None:
        return []
    try:
        out = proc.stdout.read() if proc.stdout else ""
    except (OSError, ValueError):
        out = ""
    finally:
        if proc.stdout is not None:
            proc.stdout.close()
    return out.splitlines()[-n:]


def counters(registry) -> dict:
    return dict(registry.snapshot()["counters"])


def replica_launches(ctrl: str) -> dict:
    """``{rank: (paged kernel launches, decode rounds)}`` from the exit
    snapshots of the replicas that exited through their drain (a
    SIGKILLed one writes none)."""
    out = {}
    for name in sorted(os.listdir(ctrl)):
        if not (name.startswith("metrics_") and name.endswith(".json")):
            continue
        label = name[len("metrics_"):-len(".json")]
        if not label.isdigit():
            continue
        with open(os.path.join(ctrl, name)) as f:
            gauges = json.load(f).get("gauges", {})
        if "serve.paged_attention_launches" in gauges:
            out[int(label)] = (int(gauges["serve.paged_attention_launches"]),
                               int(gauges.get("serve.decode_steps", 0)))
    return out


def frontdoor(ctrl: str, **overrides):
    from ..serving import FrontDoor, FrontDoorConfig

    kw = dict(request_timeout_s=60.0, attempt_timeout_s=6.0, max_attempts=10,
              max_hedges=0,  # hedging only where a scenario measures it
              breaker_cooldown_s=1.0)
    kw.update(overrides)
    return FrontDoor(ctrl, FrontDoorConfig(**kw))


class Serving:
    """A front door over ``ctrl`` under a flight recorder, closed on exit
    whatever happens (its sockets with it)."""

    def __init__(self, ctrl: str, **overrides):
        self.ctrl, self.overrides = ctrl, overrides
        self.fd = None
        self._rec = None

    def __enter__(self):
        from ..obs import flight_recorder

        self.fd = frontdoor(self.ctrl, **self.overrides)
        self._rec = flight_recorder(self.ctrl, 90, source="frontdoor",
                                    registry=self.fd.metrics)
        self._rec.__enter__()
        self.fd.start()
        return self.fd

    def __exit__(self, *exc):
        try:
            self.fd.write_metrics()
        finally:
            try:
                self.fd.close()
            finally:
                self._rec.__exit__(*exc)
        return False


def submit(fd, req) -> bool:
    return fd.submit(req["rid"], req["prompt"], req["max_new"])


# --------------------------------------------------------------------------
# scenarios
# --------------------------------------------------------------------------


def launch_checks(ctrl: str, oracle: Oracle) -> dict:
    """The drained replicas' paged launches against the code's count: a
    launch a layer a decode round on a card, none on the CPU (the plain
    stream launches nothing).  At least one replica must have drained and
    written its count; a SIGKILLed replica writes none, so its launches
    are missing from ``paged_launches``."""
    got = replica_launches(ctrl)
    per = oracle.cfg.n_layers if oracle.device.startswith("cuda") else 0
    return {"by_rank": {str(r): v for r, v in got.items()},
            "paged_launches": sum(v[0] for v in got.values()),
            "launches_the_codes": bool(got) and all(
                v[0] == v[1] * per for v in got.values())}


def run_sigkill_scenario(workdir: str, oracle: Oracle) -> dict:
    """SIGKILL one of two replicas while both decode."""
    ctrl = os.path.join(workdir, "ctrl")
    os.makedirs(ctrl, exist_ok=True)
    procs = {r: spawn_replica(ctrl, r, oracle.device,
                              {"FT_RPC_DECODE_SLEEP": "0.05"})
             for r in range(2)}
    requests = build_requests(seed=11, n=6)
    kill_rc = None
    try:
        wait_ready(ctrl, procs, procs)
        with Serving(ctrl) as fd:
            for req in requests:
                submit(fd, req)
            time.sleep(0.4)  # both replicas hold in-flight work
            os.kill(procs[0].pid, signal.SIGKILL)
            idle = fd.wait_idle(timeout_s=RUN_TIMEOUT_S)
            count = counters(fd.metrics)
        procs[0].wait(timeout=10.0)
        kill_rc = procs[0].returncode
    finally:
        rcs = shutdown(procs)
    bad = bitwise_violations(fd, requests, oracle)
    floors = {
        "killed_by_sigkill": kill_rc == -signal.SIGKILL,
        "all_completed_exactly_once": idle and sorted(fd.completed) == [
            r["rid"] for r in requests] and not fd.failed,
        "bitwise_vs_generate": not bad,
        "retries_accounted": count.get("serve.retries", 0) >= 1,
        "zero_duplicate_results":
            count.get("serve.duplicate_results", 0) == 0,
    }
    return {"scenario": "sigkill_mid_decode",
            "injection": "SIGKILL of replica 0 with decode in flight "
                         "(FT_RPC_DECODE_SLEEP=0.05 widens the window)",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"rcs": {**rcs, 0: kill_rc}, "counters": count,
                       "bitwise_bad_rids": bad, "failed": dict(fd.failed),
                       "attempts": {rid: res.attempts for rid, res in
                                    sorted(fd.completed.items())},
                       "launches": launch_checks(ctrl, oracle)}}


def run_drain_scenario(workdir: str, oracle: Oracle) -> dict:
    """SIGTERM one of two replicas mid-run: drain, re-route, exit 0."""
    from ..obs.timeline import read_dir

    ctrl = os.path.join(workdir, "ctrl")
    os.makedirs(ctrl, exist_ok=True)
    procs = {r: spawn_replica(ctrl, r, oracle.device,
                              {"FT_RPC_DECODE_SLEEP": "0.05"})
             for r in range(2)}
    requests = build_requests(seed=13, n=6)
    drained_rc = None
    try:
        wait_ready(ctrl, procs, procs)
        with Serving(ctrl) as fd:
            for req in requests:
                submit(fd, req)
            time.sleep(0.4)
            procs[0].send_signal(signal.SIGTERM)
            idle = fd.wait_idle(timeout_s=RUN_TIMEOUT_S)
            count = counters(fd.metrics)
        procs[0].wait(timeout=20.0)
        drained_rc = procs[0].returncode
    finally:
        rcs = shutdown(procs)
    bad = bitwise_violations(fd, requests, oracle)
    drains = [e for e in read_dir(ctrl)[0] if e.get("kind") == "drain"]
    floors = {
        "drained_exit_zero": drained_rc == 0,
        "drain_rerouted": count.get("serve.drains", 0) >= 1,
        "drain_event_recorded": any(e.get("refused", 0) >= 1
                                    for e in drains),
        "all_completed_exactly_once": idle and sorted(fd.completed) == [
            r["rid"] for r in requests] and not fd.failed,
        "bitwise_vs_generate": not bad,
        "zero_duplicate_results":
            count.get("serve.duplicate_results", 0) == 0,
    }
    return {"scenario": "graceful_drain",
            "injection": "SIGTERM of replica 0 with requests in flight",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"rcs": {**rcs, 0: drained_rc}, "counters": count,
                       "drain_events": drains[:4], "bitwise_bad_rids": bad,
                       "failed": dict(fd.failed),
                       "launches": launch_checks(ctrl, oracle)}}


def _stall_run(workdir, tag, requests, warm, device, *, max_hedges) -> dict:
    """One SIGSTOP-straggler run: warm the hedge trigger's window, burst
    the measured batch, stall replica 0, harvest."""
    ctrl = os.path.join(workdir, f"ctrl_{tag}")
    os.makedirs(ctrl, exist_ok=True)
    procs = {r: spawn_replica(ctrl, r, device,
                              {"FT_RPC_DECODE_SLEEP": "0.05"})
             for r in range(2)}
    try:
        wait_ready(ctrl, procs, procs)
        with Serving(ctrl, attempt_timeout_s=6.0, max_hedges=max_hedges,
                     hedge_min_samples=8, hedge_factor=1.5,
                     slo_window_s=60.0) as fd:
            for req in warm:  # prime the windowed-p99 hedge trigger
                submit(fd, req)
            fd.wait_idle(timeout_s=RUN_TIMEOUT_S)
            for req in requests:
                submit(fd, req)
            time.sleep(0.2)  # in-flight work on both replicas
            os.kill(procs[0].pid, signal.SIGSTOP)
            idle = fd.wait_idle(timeout_s=RUN_TIMEOUT_S)
            count = counters(fd.metrics)
            os.kill(procs[0].pid, signal.SIGCONT)
    finally:
        try:
            os.kill(procs[0].pid, signal.SIGCONT)
        except OSError:
            pass
        rcs = shutdown(procs)
    ttfts = sorted(res.ttft_s for rid, res in fd.completed.items()
                   if rid >= requests[0]["rid"])
    return {"fd": fd, "idle": idle, "counters": count, "rcs": rcs,
            "p99_ttft_s": float(np.percentile(ttfts, 99)) if ttfts else None,
            "hedged_rids": sorted(rid for rid, res in fd.completed.items()
                                  if res.hedged)}


def run_sigstop_scenario(workdir: str, oracle: Oracle) -> dict:
    """The hedging A/B: one workload and one SIGSTOP stall, with
    windowed-p99 hedging and with ``max_hedges=0``."""
    warm = [dict(r, rid=100 + r["rid"])
            for r in build_requests(seed=17, n=8, max_new=(4,))]
    requests = [dict(r, rid=200 + r["rid"])
                for r in build_requests(seed=19, n=8)]
    hedged = _stall_run(workdir, "hedge", requests, warm, oracle.device,
                        max_hedges=1)
    plain = _stall_run(workdir, "nohedge", requests, warm, oracle.device,
                       max_hedges=0)
    bad = bitwise_violations(hedged["fd"], requests + warm, oracle)
    bad += bitwise_violations(plain["fd"], requests + warm, oracle)
    want = sorted(r["rid"] for r in warm + requests)
    floors = {
        "hedges_fired": hedged["counters"].get("serve.hedges", 0) >= 1,
        "no_hedges_in_twin": plain["counters"].get("serve.hedges", 0) == 0,
        "hedged_beats_no_hedge_p99_ttft": (
            hedged["p99_ttft_s"] is not None
            and plain["p99_ttft_s"] is not None
            and hedged["p99_ttft_s"] < plain["p99_ttft_s"]),
        "all_completed_exactly_once": all(
            run["idle"] and sorted(run["fd"].completed) == want
            and not run["fd"].failed for run in (hedged, plain)),
        "bitwise_vs_generate": not bad,
        "zero_duplicate_results": all(
            run["counters"].get("serve.duplicate_results", 0) == 0
            for run in (hedged, plain)),
    }
    return {"scenario": "sigstop_straggler_hedged",
            "injection": "SIGSTOP of replica 0 holding in-flight requests; "
                         "hedged run vs max_hedges=0 twin on the same "
                         "workload and stall",
            "ok": all(floors.values()), "floors": floors,
            "checks": {
                "hedged": {k: hedged[k] for k in ("p99_ttft_s",
                                                  "hedged_rids", "counters",
                                                  "rcs")},
                "no_hedge": {k: plain[k] for k in ("p99_ttft_s", "counters",
                                                   "rcs")},
                "bitwise_bad_rids": bad}}


def run_torn_scenario(workdir: str, oracle: Oracle) -> dict:
    """One replica tears every 3rd response frame: each tear caught by
    the CRC, retried, and replayed from the idempotency store."""
    from ..obs.timeline import read_dir

    ctrl = os.path.join(workdir, "ctrl")
    os.makedirs(ctrl, exist_ok=True)
    # one replica: every retry returns to the tearer, so the dedup floor
    # (answered from the store, not run again) is deterministic
    procs = {0: spawn_replica(ctrl, 0, oracle.device,
                              {"FT_RPC_TEAR_EVERY": "3"})}
    requests = build_requests(seed=23, n=6)
    try:
        wait_ready(ctrl, procs, procs)
        with Serving(ctrl, attempt_timeout_s=8.0) as fd:
            for req in requests:
                submit(fd, req)
            idle = fd.wait_idle(timeout_s=RUN_TIMEOUT_S)
            count = counters(fd.metrics)
    finally:
        rcs = shutdown(procs)
    bad = bitwise_violations(fd, requests, oracle)
    tears = sum(1 for e in read_dir(ctrl)[0]
                if e.get("kind") == "rpc_tear_injected")
    with open(os.path.join(ctrl, "metrics_00000.json")) as f:
        replica_snap = json.load(f)  # the replica's exit snapshot
    dedup_hits = replica_snap["counters"].get("serve.dedup_hits", 0)
    floors = {
        "tears_injected": tears >= 1,
        "tears_detected_and_retried": count.get("serve.retries", 0) >= 1,
        "dedup_replay_from_store": dedup_hits >= 1,
        "all_completed_exactly_once": idle and sorted(fd.completed) == [
            r["rid"] for r in requests] and not fd.failed,
        "no_torn_stream_delivered": not bad,  # bitwise is the proof
        "zero_duplicate_results":
            count.get("serve.duplicate_results", 0) == 0,
    }
    return {"scenario": "torn_frames",
            "injection": "FT_RPC_TEAR_EVERY=3: one byte flipped inside "
                         "every 3rd response frame (length header intact: "
                         "only the CRC trailer catches it)",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"rcs": rcs, "tears_injected": tears,
                       "dedup_hits": dedup_hits, "counters": count,
                       "bitwise_bad_rids": bad, "failed": dict(fd.failed),
                       "launches": launch_checks(ctrl, oracle)}}


def run_spike_scenario(workdir: str, oracle: Oracle) -> dict:
    """An open-loop Poisson burst over one slow replica: intake sheds,
    and every rid is exactly one of completed / shed / failed."""
    from ..obs.timeline import read_dir

    ctrl = os.path.join(workdir, "ctrl")
    os.makedirs(ctrl, exist_ok=True)
    procs = {0: spawn_replica(ctrl, 0, oracle.device,
                              {"FT_RPC_DECODE_SLEEP": "0.05"})}
    n = 32
    requests = build_requests(seed=29, n=n, max_new=(8,))
    gaps = np.random.default_rng(31).exponential(1.0 / 400.0, size=n)
    admitted = 0
    try:
        wait_ready(ctrl, procs, procs)
        with Serving(ctrl, shed_outstanding=8, attempt_timeout_s=10.0) as fd:
            for req, gap in zip(requests, gaps):
                time.sleep(float(gap))  # open loop: arrivals do not wait
                if submit(fd, req):
                    admitted += 1
            idle = fd.wait_idle(timeout_s=RUN_TIMEOUT_S)
            count = counters(fd.metrics)
    finally:
        rcs = shutdown(procs)
    bad = bitwise_violations(fd, requests, oracle)
    shed_events = [e for e in read_dir(ctrl)[0]
                   if e.get("kind") == "serve_shed"
                   and e.get("where") == "frontdoor"]
    shed, done, failed = set(fd.shed_rids), set(fd.completed), set(fd.failed)
    floors = {
        "spike_shed_something": len(shed) >= 1,
        "spike_served_something": len(done) >= 1,
        "every_rid_accounted_once": (
            not (done & shed) and not (done & failed)
            and not (shed & failed)
            and done | shed | failed == {r["rid"] for r in requests}),
        "no_failures": not failed,
        "shed_counter_agrees": count.get("serve.shed", 0) == len(shed),
        "shed_event_per_rid": {e.get("rid") for e in shed_events} == shed,
        "bitwise_vs_generate": not bad,
    }
    return {"scenario": "poisson_spike",
            "injection": f"open-loop Poisson burst, {n} requests at ~400 "
                         "rps into shed_outstanding=8 over one slow replica",
            "ok": all(floors.values()), "floors": floors,
            "checks": {"rcs": rcs, "admitted": admitted,
                       "completed": len(done), "shed": sorted(shed),
                       "failed": dict(fd.failed), "counters": count,
                       "bitwise_bad_rids": bad, "idle": idle,
                       "launches": launch_checks(ctrl, oracle)}}


SCENARIOS = {
    "sigkill": run_sigkill_scenario,
    "drain": run_drain_scenario,
    "sigstop": run_sigstop_scenario,
    "torn": run_torn_scenario,
    "spike": run_spike_scenario,
}
SMOKE = ["sigkill", "torn", "spike"]  # one replica boot-set each


def run_matrix(names, oracle: Oracle, log=print, runners=None) -> list:
    """Run ``names`` in order; a crashed scenario is a failed floor."""
    runners = runners or SCENARIOS
    results = []
    with tempfile.TemporaryDirectory(prefix="ft-rpc-chaos-") as wd:
        for name in names:
            sub = os.path.join(wd, name)
            os.makedirs(sub, exist_ok=True)
            log(f"=== scenario {name} ===")
            t0 = time.monotonic()
            try:
                res = runners[name](sub, oracle)
            except Exception as e:
                res = {"scenario": name, "ok": False,
                       "error": f"{type(e).__name__}: {e}", "floors": {}}
            res["seconds"] = time.monotonic() - t0
            log(f"scenario {res['scenario']}: "
                f"{'OK' if res['ok'] else 'FAILED'} "
                + json.dumps(res.get("floors", {}))
                + (f" {res['error']}" if "error" in res else "")
                + f" ({res['seconds']:.1f} s)")
            results.append(res)
    return results


def parser(description, scenarios, smoke, default_out):
    ap = argparse.ArgumentParser(description=description)
    ap.add_argument("--smoke", action="store_true",
                    help="the subset " + ", ".join(smoke))
    ap.add_argument("--only", default="",
                    help="a comma-separated subset of "
                         + ", ".join(scenarios))
    ap.add_argument("--device", default=None,
                    help="the replicas' and the oracle's device: cuda "
                         "(default) or cpu")
    ap.add_argument("--out", default=default_out)
    ap.add_argument("--no-artifact", action="store_true")
    return ap


def names_of(ap, args, scenarios, smoke) -> list:
    if args.only:
        names = [n for n in args.only.split(",") if n]
        unknown = [n for n in names if n not in scenarios]
        if unknown:
            ap.error(f"--only: unknown scenarios {unknown}")
        return names
    return list(smoke) if args.smoke else list(scenarios)


def main(argv=None) -> int:
    ap = parser(__doc__.split("\n\n")[0], SCENARIOS, SMOKE,
                os.path.join("tmp", "rpc_chaos.json"))
    args = ap.parse_args(argv)
    out = None if args.no_artifact else checked_out(ap, args.out)
    names = names_of(ap, args, SCENARIOS, SMOKE)
    from ..device import resolve_device

    device = str(resolve_device(args.device))
    print("building the generate oracle (single-process greedy, f32)...",
          flush=True)
    oracle = Oracle(device)
    results = run_matrix(names, oracle)
    for r in results:
        r.pop("fd", None)
    ok = all(r["ok"] for r in results)
    if out is not None:
        with open(out, "w") as f:
            json.dump({"ok": ok, "smoke": args.smoke, "device": device,
                       "model": model_args(device),
                       "scenarios": {r["scenario"]: r for r in results},
                       "finished": datetime.datetime.now(
                           datetime.timezone.utc).isoformat(
                               timespec="seconds")},
                      f, indent=1, sort_keys=True, default=str)
        print(f"wrote {out} (ok={ok})")
    return 0 if ok else 1


if __name__ == "__main__":
    raise SystemExit(main())
