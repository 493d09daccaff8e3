"""Static analysis: the schedule model checker, the protocol checker and
the concurrency lint.

The port's copy of part of ``flextree_tpu/analysis``: the
:class:`~.base.Violation` record, the message-program checks of
``schedule_check`` that ``schedule.ir.compile_ir`` runs before it lowers a
program, the phase-program checks of the standalone reduce-scatter and
all-gather that ZeRO-1 runs, and ``protocol_check``'s exhaustive
exploration of the coordination, lease, RPC and KV-migration models, and
``concurrency_lint``'s lock-discipline scan of the threaded host code
(over ``flextree_tpu_torch/`` by default).  The JAX package's HLO and
jit-hygiene lints are not ported (ROADMAP.md, Queue 1:
'JAX-specific static analysis, last').
"""

from .base import Violation, violations_to_json
from .concurrency_lint import run_concurrency_lint, scan_file, scan_source
from .protocol_check import default_models, explore, run_protocol_check
from .schedule_check import (
    build_phase_program,
    check_ir,
    check_ir_families,
    check_phase_program,
    check_program,
    check_split_schedules,
    default_ir_matrix,
    default_phase_matrix,
    program_from_ir,
)

__all__ = [
    "Violation",
    "violations_to_json",
    "build_phase_program",
    "check_ir",
    "check_ir_families",
    "check_phase_program",
    "check_program",
    "check_split_schedules",
    "default_ir_matrix",
    "default_phase_matrix",
    "program_from_ir",
    "default_models",
    "explore",
    "run_protocol_check",
    "run_concurrency_lint",
    "scan_file",
    "scan_source",
]
