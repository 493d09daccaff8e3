"""Shared vocabulary of the static-analysis suite: the Violation record.

A copy of ``flextree_tpu/analysis/base.py`` (the port imports nothing of
the JAX package).

Every layer (schedule model checker, HLO linter, jit-hygiene lint) reports
findings as :class:`Violation` rows so the CLI, the CI gate, and the
mutation self-test can treat them uniformly.  A violation is *located*:
schedule violations name ``(stage, src, dst, block)``, HLO violations name
the entrypoint and the offending op line, jit-hygiene violations name
``file:line``.  ``detail`` is always a full human sentence — the analyzer
explains, it does not just flag.
"""

from __future__ import annotations

from dataclasses import asdict, dataclass

__all__ = ["Violation", "violations_to_json"]


@dataclass(frozen=True)
class Violation:
    """One analyzer finding.

    ``layer``: ``"schedule"`` | ``"hlo"`` | ``"jit"`` | ``"protocol"`` |
    ``"concurrency"``.
    ``kind``: a stable machine-readable class (``"deadlock"``,
    ``"double-count"``, ``"dropped-block"``, ``"asymmetric-match"``,
    ``"chunk-overlap"``, ``"unbounded-wait"``, ``"budget"``,
    ``"dtype-drift"``, ``"host-transfer"``, ``"donation"``,
    ``"wall-clock"``, ``"rng"``, ``"traced-branch"``,
    ``"static-argnames"``; protocol kinds like ``"epoch-double-commit"``,
    ``"double-grant"``, ``"completed-rid-reexecuted"``,
    ``"clean-rank-fenced"``; concurrency kinds ``"lock-order"``,
    ``"lock-blocking"``, ``"guard"``, ``"signal-blocking"``) — the
    mutation self-test asserts on these.
    ``where``: entrypoint / schedule / file the finding is in.
    ``stage``/``src``/``dst``/``block``: schedule coordinates (None for the
    other layers; ``src``/``dst`` double as line numbers for jit findings).
    """

    layer: str
    kind: str
    where: str
    detail: str
    stage: int | None = None
    src: int | None = None
    dst: int | None = None
    block: int | None = None

    def __str__(self) -> str:
        loc = ""
        if self.stage is not None or self.src is not None:
            coords = ", ".join(
                f"{k}={v}"
                for k, v in (
                    ("stage", self.stage),
                    ("src", self.src),
                    ("dst", self.dst),
                    ("block", self.block),
                )
                if v is not None
            )
            loc = f" [{coords}]"
        return f"{self.layer}/{self.kind} @ {self.where}{loc}: {self.detail}"


def violations_to_json(violations) -> list[dict]:
    """JSON-ready rows (stable key order, no Nones dropped — the report is
    a committed artifact and diffs should be meaningful)."""
    return [asdict(v) for v in violations]
