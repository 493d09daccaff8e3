"""Pure schedule/topology layer — no torch, no devices.

The port's copy of the JAX package's ``flextree_tpu/schedule`` (widths,
stage groups, block layout and the shard contract, per-rank plans and
their validator), the analog of the reference's L2 layer
(``mpi_mod.hpp:45-214, 882-929``), and of its declarative schedule IR
(``ir``: the tree, ring, lonely, swing and generalized programs that
``compile_ir`` model-checks before it lowers them).  The native planner
bridge (``schedule/native.py``) is not ported (ROADMAP.md, Queue 1:
'``schedule/native.py``').
"""

from .stages import (
    FT_TOPO_ENV,
    LonelyTopology,
    Topology,
    TopologyError,
    get_stages,
    parse_topo,
    split_lonely_spec,
)
from .blocks import BlockLayout, owned_block, shard_layout
from .plan import (
    Operation,
    tree_block_set,
    send_plan,
    recv_plan,
    owned_blocks,
    ring_plan,
    format_plan,
)
from .validate import ScheduleError, ValidationStats, validate, validate_ring, validate_topology
from .ir import (
    IR_FAMILIES,
    IRFamilySpec,
    IRProgram,
    IRStage,
    IRViolationError,
    IRXfer,
    compile_ir,
    emit_ir,
    generalized_ir,
    lonely_ir,
    parse_ir_family_spec,
    resolve_collective,
    ring_ir,
    swing_ir,
    tree_ir,
    verify_ir,
)

__all__ = [
    "ScheduleError",
    "ValidationStats",
    "validate",
    "validate_topology",
    "validate_ring",
    "Topology",
    "LonelyTopology",
    "TopologyError",
    "split_lonely_spec",
    "parse_topo",
    "get_stages",
    "FT_TOPO_ENV",
    "BlockLayout",
    "owned_block",
    "shard_layout",
    "Operation",
    "tree_block_set",
    "send_plan",
    "recv_plan",
    "owned_blocks",
    "ring_plan",
    "format_plan",
    "IR_FAMILIES",
    "IRFamilySpec",
    "IRProgram",
    "IRStage",
    "IRViolationError",
    "IRXfer",
    "compile_ir",
    "emit_ir",
    "generalized_ir",
    "lonely_ir",
    "parse_ir_family_spec",
    "resolve_collective",
    "ring_ir",
    "swing_ir",
    "tree_ir",
    "verify_ir",
]
