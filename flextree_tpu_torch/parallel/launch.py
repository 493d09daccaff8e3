"""Process bring-up on ``torch.distributed`` — the deployment layer.

PyTorch counterpart of the bring-up half of
``flextree_tpu/parallel/launch.py``.  The reference deploys with an MPI
hostfile and ``mpirun`` (``allreduce_over_mpi/Makefile:8-24``); the JAX
package with ``jax.distributed.initialize``; the port with
``torch.distributed.init_process_group`` over a TCP rendezvous at the
coordinator: NCCL for CUDA tensors, gloo for CPU tensors (or for CUDA
tensors staged through the host, see :mod:`.allreduce`).  Nothing on a
machine tells a program of its cluster, so the coordinator, the process
count and this process's id come from a :class:`ClusterConfig` (a JSON
file, or ``FT_COORDINATOR`` / ``FT_NUM_PROCESSES`` / ``FT_PROCESS_ID``).

Failures keep the JAX package's taxonomy: a malformed config raises
:class:`BringupConfigError` at once; a world that does not assemble within
the retry budget raises :class:`BringupTimeout` carrying every attempt's
error.  :func:`init_distributed_or_degrade` forms the world of the
survivors when the launcher reports fewer live processes than configured,
and replans the allreduce for them (``planner.choose.replan_for_survivors``).
:func:`spawn` runs a function on N local processes, each brought up by
:func:`init_distributed`, with a deadline on the whole world.

Not ported: the hybrid DCN x ICI meshes (``hybrid_mesh``,
``plan_for_mesh`` and their kin), ROADMAP.md Queue 1, item 11.
"""

from __future__ import annotations

import datetime
import gc
import json
import os
import random
import socket
import time
from dataclasses import dataclass, field
from pathlib import Path

__all__ = [
    "ClusterConfig",
    "init_distributed",
    "init_distributed_or_degrade",
    "shutdown_distributed",
    "spawn",
    "free_port",
    "BringupError",
    "BringupConfigError",
    "BringupTimeout",
    "BringupReport",
    "FT_INIT_TIMEOUT_ENV",
    "FT_INIT_RETRIES_ENV",
]

# env knobs for the bring-up retry wrapper: per-attempt deadline in
# seconds, and how many times a failed bring-up is retried
FT_INIT_TIMEOUT_ENV = "FT_INIT_TIMEOUT"
FT_INIT_RETRIES_ENV = "FT_INIT_RETRIES"

# injection points for the tests (patch these, not time.*)
_sleep = time.sleep
_monotonic = time.monotonic


class BringupError(RuntimeError):
    """Base of the launch-failure taxonomy."""


class BringupConfigError(BringupError):
    """The cluster config itself is invalid — retrying cannot help."""


class BringupTimeout(BringupError):
    """The world did not assemble before the deadline/retry budget.

    Carries ``attempts`` and the per-attempt error strings so the caller
    can see *why* each attempt failed.
    """

    def __init__(self, msg: str, attempts: int, errors: list[str]):
        super().__init__(msg)
        self.attempts = attempts
        self.errors = errors


@dataclass
class BringupReport:
    """What the retry wrapper did to get the runtime up."""

    attempts: int = 0
    elapsed_s: float = 0.0
    errors: list = field(default_factory=list)  # one string per failed attempt
    backend: str | None = None  # None: single process, nothing brought up
    degraded_to: int | None = None  # survivor world size, when degraded


@dataclass(frozen=True)
class ClusterConfig:
    """Process-level launch description (one file shared by every host).

    ``coordinator``: ``host:port`` of process 0, where the rendezvous
    listens.  ``num_processes``: the world size.  ``process_id``: this
    process's rank — usually not stored in the shared file but taken from
    ``FT_PROCESS_ID``, the way MPI ranks come from the launcher.
    """

    coordinator: str | None = None
    num_processes: int | None = None
    process_id: int | None = None

    @classmethod
    def from_file(cls, path: str | Path) -> "ClusterConfig":
        raw = json.loads(Path(path).read_text())
        unknown = set(raw) - {"coordinator", "num_processes", "process_id"}
        if unknown:
            raise ValueError(f"unknown cluster-config keys: {sorted(unknown)}")
        return cls(**raw)

    @classmethod
    def from_env(cls) -> "ClusterConfig":
        """Read ``FT_COORDINATOR`` / ``FT_NUM_PROCESSES`` / ``FT_PROCESS_ID``
        — the launcher-provided triple, like MPI rank env vars."""
        num = os.environ.get("FT_NUM_PROCESSES")
        pid = os.environ.get("FT_PROCESS_ID")
        return cls(
            coordinator=os.environ.get("FT_COORDINATOR"),
            num_processes=int(num) if num else None,
            process_id=int(pid) if pid else None,
        )

    def merged(self, other: "ClusterConfig") -> "ClusterConfig":
        """Fields of ``other`` win where set (env overrides file)."""
        return ClusterConfig(
            coordinator=other.coordinator or self.coordinator,
            num_processes=other.num_processes or self.num_processes,
            process_id=other.process_id if other.process_id is not None else self.process_id,
        )


def _resolve_config(config, merge_env: bool = True) -> ClusterConfig:
    """The cluster-config handshake: file/object + env overrides.  Raises
    :class:`BringupConfigError` for malformed configs and lets transient
    file errors (the launcher still writing the file) propagate so the
    retry loop can wait them out."""
    if isinstance(config, ClusterConfig):
        cfg = config
    elif config is not None:
        try:
            cfg = ClusterConfig.from_file(config)
        except json.JSONDecodeError:
            raise  # possibly mid-write by the launcher: transient, retryable
        except (ValueError, TypeError) as e:  # malformed keys/types
            raise BringupConfigError(f"bad cluster config {config}: {e}") from e
    else:
        cfg = ClusterConfig()
    cfg = cfg.merged(ClusterConfig.from_env()) if merge_env else cfg
    if cfg.num_processes not in (None, 1) or cfg.coordinator is not None:
        if not cfg.coordinator or ":" not in cfg.coordinator:
            raise BringupConfigError(
                f"coordinator must be host:port, got {cfg.coordinator!r}")
        if cfg.num_processes is None or cfg.process_id is None:
            raise BringupConfigError(
                "a multi-process world needs num_processes and process_id")
        if not 0 <= cfg.process_id < cfg.num_processes:
            raise BringupConfigError(
                f"process_id {cfg.process_id} outside a world of "
                f"{cfg.num_processes}")
    return cfg


def _probe_coordinator(coordinator: str, budget_s: float) -> None:
    """Bounded TCP reachability check of the coordinator's port, so a
    non-coordinator process waits for the rendezvous outside
    ``init_process_group`` and the wait stays a catchable, retryable
    :class:`ConnectionError`."""
    host, _, port = coordinator.rpartition(":")
    deadline = _monotonic() + budget_s
    last: Exception | None = None
    while True:
        try:
            with socket.create_connection(
                (host or "localhost", int(port)), timeout=min(budget_s, 2.0)
            ):
                return
        except OSError as e:
            last = e
        if _monotonic() >= deadline:
            raise ConnectionError(
                f"coordinator {coordinator} unreachable for {budget_s:.0f}s "
                f"({last})"
            )
        _sleep(0.25)


def init_distributed(
    config: ClusterConfig | str | Path | None = None,
    *,
    backend: str | None = None,
    device=None,
    timeout: float | None = None,
    retries: int | None = None,
    backoff: float = 0.5,
    max_backoff: float = 8.0,
    merge_env: bool = True,
) -> BringupReport:
    """Bring up the default process group (idempotent), with retry/backoff.

    ``config``: a :class:`ClusterConfig`, a path to its JSON file, or None;
    env vars (``FT_*``) override file values.  No-op when a group is
    already up or when the world is one process with no coordinator
    configured (the single-process dev loop); a coordinator with
    ``num_processes=1`` brings up a world of one.  ``backend``: ``"nccl"``
    or ``"gloo"``; by default NCCL when ``device`` is a GPU, else gloo.
    ``device`` goes through :func:`~..device.resolve_device`: ``cuda``
    unless named, so a host with no GPU must ask for ``device="cpu"`` or
    ``backend="gloo"`` (otherwise :class:`BringupConfigError`).

    ``timeout`` is the per-attempt deadline in seconds (env
    ``FT_INIT_TIMEOUT``; default 300): a non-coordinator process first
    probes the coordinator's port for that long, then the rendezvous and
    the group's operations get it as their timeout.  ``retries`` failed
    attempts are retried (env ``FT_INIT_RETRIES``, default 2), spaced by
    exponential backoff with jitter starting at ``backoff`` seconds, so the
    worst case is bounded by ``(retries+1)*timeout + sum(backoffs)``.  A
    malformed config raises :class:`BringupConfigError` at once; an
    exhausted budget raises :class:`BringupTimeout`.
    """
    import torch.distributed as dist

    from ..device import resolve_device

    report = BringupReport()
    if dist.is_initialized():
        report.backend = dist.get_backend()
        return report
    if timeout is None:
        env_t = os.environ.get(FT_INIT_TIMEOUT_ENV)
        timeout = float(env_t) if env_t else 300.0
    if retries is None:
        env_r = os.environ.get(FT_INIT_RETRIES_ENV)
        retries = int(env_r) if env_r else 2
    t_start = _monotonic()
    attempt = 0
    while True:
        attempt += 1
        report.attempts = attempt
        store = None
        try:
            cfg = _resolve_config(config, merge_env=merge_env)
            if cfg.coordinator is None and cfg.num_processes in (None, 1):
                return report  # single-process run: nothing to initialize
            if backend is None:
                try:
                    dev = resolve_device(device)
                except RuntimeError as e:  # no GPU: retrying cannot help
                    raise BringupConfigError(str(e)) from e
                backend = "nccl" if dev.type == "cuda" else "gloo"
            if cfg.process_id != 0:
                _probe_coordinator(cfg.coordinator, timeout)
            host, _, port = cfg.coordinator.rpartition(":")
            wait = datetime.timedelta(seconds=timeout)
            store = dist.TCPStore(host or "localhost", int(port),
                                  cfg.num_processes, cfg.process_id == 0,
                                  timeout=wait)
            # keys of a world of this size only: a process that reaches a
            # coordinator still serving an earlier, larger world (a
            # degraded bring-up racing the full one) times out and
            # retries instead of meeting that world's keys
            dist.init_process_group(
                backend=backend,
                store=dist.PrefixStore(f"ft_world_{cfg.num_processes}",
                                       store),
                world_size=cfg.num_processes,
                rank=cfg.process_id,
                timeout=wait,
            )
            report.elapsed_s = _monotonic() - t_start
            report.backend = backend
            return report
        except BringupConfigError:
            raise
        except Exception as e:  # transient: connect refused, timeout, ...
            report.errors.append(f"{type(e).__name__}: {e}")
            store = None  # the coordinator's port goes with it
            _reset_partial_bringup()
            if attempt > retries:
                report.elapsed_s = _monotonic() - t_start
                raise BringupTimeout(
                    f"distributed bring-up failed after {attempt} attempt(s) "
                    f"in {report.elapsed_s:.1f}s; last error: {e}",
                    attempt,
                    report.errors,
                ) from e
            delay = min(backoff * (2 ** (attempt - 1)), max_backoff)
            delay *= 0.5 + random.random() / 2  # jitter: avoid retry stampede
            _sleep(delay)


def _reset_partial_bringup() -> None:
    """Release what a failed ``init_process_group`` left behind: a default
    group that came up half way, and on process 0 the rendezvous's
    ``TCPStore``, which still holds the coordinator's port while any frame
    of the failed attempt refers to it.  The retry, or the degraded
    world's bring-up, listens on the same port.  The group counter, which
    names the default group's keys in the store, goes back to 0, so a
    process that failed more attempts than its peers still meets them
    under the same keys."""
    import sys

    import torch.distributed as dist

    from torch.distributed import distributed_c10d as c10d

    world = getattr(c10d, "_world", None)
    if not hasattr(world, "group_count"):
        # without the reset a survivor can meet its peers under other
        # keys and hang in its first collective: refuse instead
        raise BringupConfigError(
            "torch.distributed has no _world.group_count to reset after a "
            "failed bring-up; this torch is not supported")
    if dist.is_initialized():
        dist.destroy_process_group()
    world.group_count = 0
    # the exception being handled keeps the failed attempt's frames (and
    # the store they hold) alive; drop its traceback, then collect
    exc = sys.exc_info()[1]
    if exc is not None:
        exc.__traceback__ = None
        for linked in (exc.__cause__, exc.__context__):
            if linked is not None:
                linked.__traceback__ = None
    gc.collect()


def init_distributed_or_degrade(
    config: ClusterConfig | str | Path | None = None,
    *,
    nbytes: int,
    survivors=None,
    min_processes: int = 1,
    timeout: float | None = None,
    retries: int | None = None,
    backend: str | None = None,
    device=None,
):
    """Bring up the configured world, or degrade to the survivors.

    The *launcher*, the only party that knows which processes are alive,
    supplies ``survivors`` (an int, or a callable returning one, such as a
    probe of its child processes).  When it reports fewer processes than
    configured (and at least ``min_processes``), the world is formed with
    ``num_processes = survivors`` directly, and the allreduce topology is
    replanned for the surviving count with
    :func:`~..planner.choose.replan_for_survivors` (awkward counts get a
    lonely topology or the ring, so 7 of 8 still runs a real tree).

    The decision is taken before the full-world rendezvous when the
    liveness source already reports a short world.  Otherwise the full
    world is attempted; on torch a world whose peers never register fails
    catchably (the rendezvous raises at its deadline), so on
    :class:`BringupTimeout` the liveness source is polled again and the
    same degrade applies, on the same coordinator port
    (:func:`_reset_partial_bringup` released it).  A config file caught
    mid-write by the launcher skips the upfront decision and is re-read.
    The launcher keeps the surviving ``process_id``s contiguous.
    ``backend`` and ``device`` are :func:`init_distributed`'s.

    Returns ``(report, plan)``: ``plan`` is None when the full world came
    up, else the replanned :class:`~..planner.choose.Plan` for the degraded
    world (``report.degraded_to`` names its size).
    """
    try:
        cfg = _resolve_config(config)
    except json.JSONDecodeError:
        # the launcher is still writing the shared file: skip the upfront
        # decision, init_distributed's retries re-read it
        cfg = None

    def _alive():
        return survivors() if callable(survivors) else survivors

    def _short(n_alive):
        configured = cfg.num_processes if cfg is not None else None
        return (n_alive is not None and configured is not None
                and min_processes <= n_alive < configured)

    def _degrade(n_alive, prior_attempts=0, prior_errors=()):
        from ..planner.choose import replan_for_survivors

        degraded = ClusterConfig(coordinator=cfg.coordinator,
                                 num_processes=n_alive,
                                 process_id=cfg.process_id)
        report = init_distributed(degraded, backend=backend, device=device,
                                  timeout=timeout, retries=retries,
                                  merge_env=False)
        report.attempts += prior_attempts
        report.errors = list(prior_errors) + report.errors
        report.degraded_to = n_alive
        plan = replan_for_survivors(n_alive, nbytes,
                                    configured=cfg.num_processes)
        return report, plan

    n_alive = _alive()
    if _short(n_alive):
        return _degrade(n_alive)
    try:
        return init_distributed(config, backend=backend, device=device,
                                timeout=timeout, retries=retries), None
    except BringupTimeout as full_err:
        if cfg is None:
            try:  # the full attempt's retries may have outlived the write
                cfg = _resolve_config(config)
            except json.JSONDecodeError:
                raise full_err from None
        n_alive = _alive()  # the world may have shrunk while waiting
        if not _short(n_alive):
            raise
        return _degrade(n_alive, full_err.attempts, full_err.errors)


def shutdown_distributed() -> None:
    """Destroy the default process group if one is up."""
    import torch.distributed as dist

    if dist.is_initialized():
        dist.destroy_process_group()


def free_port() -> int:
    """A TCP port on localhost that was free a moment ago."""
    with socket.socket(socket.AF_INET, socket.SOCK_STREAM) as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _spawned(rank, world, port, backend, timeout, fn, args, queue):
    result = ("error", "interrupted")
    try:
        init_distributed(ClusterConfig(f"127.0.0.1:{port}", world, rank),
                         backend=backend, timeout=timeout, retries=0,
                         merge_env=False)
        result = ("ok", fn(rank, world, *args))
    except Exception as e:  # reported to the parent, which raises
        import traceback

        result = ("error", f"{type(e).__name__}: {e}\n{traceback.format_exc()}")
    finally:
        shutdown_distributed()
        queue.put((rank, result))


def spawn(fn, world: int, args=(), *, backend: str = "gloo",
          timeout: float = 60.0) -> list:
    """Run ``fn(rank, world, *args)`` on ``world`` new local processes
    (``spawn`` start method), each with a process group brought up by
    :func:`init_distributed` on a free localhost port.  Returns the
    per-rank results in rank order.  The whole world has ``timeout``
    seconds: a rank that has not reported by then is killed, and any
    failure raises with the rank's traceback.  A rank that fails or dies
    without reporting ends the wait at once (its peers may be blocked in
    a collective with it until their process group's timeout): the
    others are killed and the failure raised.  ``fn`` and ``args`` must
    be picklable (a module-level function)."""
    import multiprocessing as mp
    import queue as queue_mod

    ctx = mp.get_context("spawn")
    q = ctx.Queue()
    port = free_port()
    procs = [ctx.Process(target=_spawned,
                         args=(r, world, port, backend, timeout, fn, args, q),
                         daemon=True)
             for r in range(world)]
    for p in procs:
        p.start()
    results: dict = {}
    deadline = _monotonic() + timeout
    try:
        while len(results) < world:
            left = deadline - _monotonic()
            if left <= 0:
                break
            try:
                rank, res = q.get(timeout=min(left, 1.0))
            except queue_mod.Empty:
                if q.empty() and any(not p.is_alive() and r not in results
                                     for r, p in enumerate(procs)):
                    break  # a rank died without reporting
                continue
            results[rank] = res
            if res[0] != "ok":
                break
    finally:
        for p in procs:
            p.join(timeout=max(0.0, min(5.0, deadline - _monotonic())))
            if p.is_alive():
                p.kill()
                p.join(timeout=5)
    while True:  # what the others reported while they were joined
        try:
            rank, res = q.get_nowait()
        except queue_mod.Empty:
            break
        results.setdefault(rank, res)
    missing = {r: procs[r].exitcode for r in range(world) if r not in results}
    errors = {r: res[1] for r, res in results.items() if res[0] != "ok"}
    if missing or errors:
        raise RuntimeError(
            f"spawned world of {world}: ranks {sorted(missing)} did not "
            f"report (exit codes {list(missing.values())}; None = killed at "
            f"the {timeout:.0f} s deadline or after a peer's failure); "
            f"errors: " + "; ".join(
                f"rank {r}: {e}" for r, e in sorted(errors.items())))
    return [results[r][1] for r in range(world)]
