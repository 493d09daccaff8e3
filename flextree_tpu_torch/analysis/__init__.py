"""Static analysis: the schedule model checker.

The port's copy of the IR part of ``flextree_tpu/analysis``: the
:class:`~.base.Violation` record and the message-program checks of
``schedule_check`` that ``schedule.ir.compile_ir`` runs before it lowers a
program.  The JAX package's HLO, jit-hygiene, protocol and concurrency
lints are not ported (ROADMAP.md, Queue 1: 'JAX-specific static analysis,
last').
"""

from .base import Violation, violations_to_json
from .schedule_check import (
    check_ir,
    check_ir_families,
    check_program,
    default_ir_matrix,
    program_from_ir,
)

__all__ = [
    "Violation",
    "violations_to_json",
    "check_ir",
    "check_ir_families",
    "check_program",
    "default_ir_matrix",
    "program_from_ir",
]
