"""Concurrency / lock-discipline lint over the threaded host code.

The port's copy of ``flextree_tpu/analysis/concurrency_lint.py``, pointed
at ``flextree_tpu_torch/`` by default (any tree can be given: the lint
reads source text and imports nothing of it).  Its device-sync rule names
the host's waits on the card: ``torch.cuda.synchronize`` and any
``.synchronize()`` (an ``Event``'s or a ``Stream``'s), and the
tensor-to-host reads ``.item()``, ``.cpu()`` and ``.tolist()``.

The runtime and serving layers are genuinely multi-threaded: dispatcher
pools, heartbeat daemons, RPC reader threads, background checkpointers,
and signal handlers all share state with the step loop.  The protocol
checker (layer 4) verifies the *cross-process* handshakes; this layer
lints the *in-process* discipline those components rely on.  Four checks,
each an AST/call-graph pass over one file at a time:

- **lock-order** — the lock-acquisition graph: every ``with <lock>:``
  region contributes an edge to each lock acquired inside it (directly
  or through a call to a same-file function that acquires one).  Any
  cycle in the graph is a potential ABBA deadlock, flagged whether or
  not today's thread schedule can hit it.
- **lock-blocking** — a blocking call (sleep, thread join, socket
  accept/recv/sendall/connect, ``Event.wait``, queue get/put, blocking
  lock acquire, ``open``/``os.fsync``, subprocess, a wait on the card:
  ``synchronize``, ``.item()``, ``.cpu()``, ``.tolist()``) made while
  holding a lock.
  Every waiter on that lock inherits the block; on the hot paths
  (recorder, metrics, front door) that is a latency cliff or a wedge.
- **guard** — write-side lock discipline, made auditable: a field whose
  ``__init__`` assignment carries ``# guarded-by: <lock>`` must only be
  written inside ``with self.<lock>:``, in a method whose name ends in
  ``_locked`` (the callee-holds-the-lock convention), on a line carrying
  ``# holds: <lock>``, or in ``__init__`` itself (no concurrency before
  construction completes).  Unannotated fields are not checked — the
  annotation is the opt-in that makes the discipline reviewable.
- **signal-blocking** — a blocking primitive (the narrow set: lock
  acquire, ``wait``, ``join``, sleep, queue ops — NOT buffered file
  I/O, which Python-level handlers may use) reachable from a function
  registered via ``signal.signal``.  A handler runs ON the thread it
  interrupted; blocking on a lock that frame may hold is a permanent
  deadlock — the exact class the recorder's ``dump_nonblocking`` (try-
  lock, skip on contention) exists to avoid.

Honest limits, by construction: resolution is per-file and name-based
(a bare call, or an attribute call whose receiver is ``self``/``cls`` or
plausibly names a same-file class, is matched against every same-file
``def`` sharing its name — ``json.dump()`` does NOT resolve to a local
``dump`` method), so cross-module blocking — ``record_event`` into the recorder, a metrics
``inc`` under a caller's lock — is invisible here; single-writer fields
need no annotation and get no check; lock identity is lexical
(``ClassName.attr``), so two instances of one class sharing the lint's
node is deliberate (the ABBA *shape* is per-class, not per-object).
False positives are waived in place with an auditable pragma::

    with self._wlock:
        send_frame(...)  # concurrency: ok — the write lock IS the serializer

The pragma must carry a reason and suppresses only its own line (or the
whole function when placed on the ``def`` line).
"""

from __future__ import annotations

import ast
import os
import re
from dataclasses import dataclass, field

from .base import Violation

__all__ = [
    "scan_source",
    "scan_file",
    "run_concurrency_lint",
    "PRAGMA",
    "GUARDED_BY",
    "HOLDS",
]

PRAGMA = "concurrency: ok"
#: ``self.x = ...  # guarded-by: _lock`` in ``__init__`` opts the field in.
GUARDED_BY = "guarded-by:"
#: ``# holds: _lock`` on a write line asserts the caller holds the lock.
HOLDS = "holds:"

#: Receiver names treated as locks in ``with`` statements / ``.acquire``.
_LOCKISH = re.compile(r"lock|mutex|cond\b|condition|sem\b|semaphore", re.I)
#: Receiver names treated as queues for ``.get`` / ``.put``.
_QUEUEISH = re.compile(r"queue|jobs|results|resq|work\b|_work|intake|inbox")
#: Receiver names treated as joinable threads/processes for ``.join``.
_THREADISH = re.compile(r"thread|proc|worker|reader|writer|^_?[tp]$")
#: Receiver names treated as sockets for ``.connect``.
_SOCKISH = re.compile(r"sock|conn", re.I)

#: Attribute calls that make the host wait on the card: a stream's, an
#: event's or the device's ``synchronize``, and the reads of a tensor
#: into host memory.
_DEVICE_SYNCS = frozenset({"synchronize", "item", "cpu", "tolist"})

#: Attribute calls that mutate their receiver in place (for guard checks).
_MUTATORS = frozenset({
    "append", "appendleft", "extend", "insert", "add", "discard", "remove",
    "pop", "popleft", "popitem", "clear", "update", "setdefault",
})

#: Constructors that make an attribute a lock (collected per class).
_LOCK_CTORS = frozenset({
    "threading.Lock", "threading.RLock", "threading.Condition",
    "threading.Semaphore", "threading.BoundedSemaphore", "Lock", "RLock",
    "Condition",
})


def _qualname(node) -> str | None:
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return ".".join(reversed(parts))
    return None


def _receiver_name(func_node) -> str | None:
    """Final receiver identifier of ``a.b.c.meth`` → ``c`` (or ``a`` for
    ``a.meth``); None for non-attribute calls."""
    if not isinstance(func_node, ast.Attribute):
        return None
    value = func_node.value
    if isinstance(value, ast.Attribute):
        return value.attr
    if isinstance(value, ast.Name):
        return value.id
    return None


def _blocking_call(node: ast.Call):
    """Classify a direct call: ``(reason, signal_unsafe)`` or None.

    ``signal_unsafe`` marks the narrow set that is also forbidden on
    signal-handler paths (buffered file I/O is allowed there — Python
    delivers signals between bytecodes, not inside C I/O — so ``open``
    and ``fsync`` are lock-hold problems only).
    """
    q = _qualname(node.func)
    last = q.rsplit(".", 1)[-1] if q else None
    recv = _receiver_name(node.func)
    if q == "open":
        return ("open() file I/O", False)
    if q in {"os.fsync", "os.fdatasync"}:
        return (f"{q}() disk barrier", False)
    if q and q.startswith("subprocess."):
        return (f"{q}() subprocess", True)
    if q == "select.select":
        return ("select.select()", True)
    if last == "sleep" or q == "_sleep":
        return ("sleep", True)
    if last in _DEVICE_SYNCS and isinstance(node.func, ast.Attribute):
        return (f".{last}() device sync", True)
    if last == "acquire" and recv and _LOCKISH.search(recv):
        for kw in node.keywords:
            if kw.arg == "blocking" and isinstance(kw.value, ast.Constant) \
                    and kw.value.value is False:
                return None  # try-lock: the signal-safe idiom
        if node.args and isinstance(node.args[0], ast.Constant) \
                and node.args[0].value is False:
            return None
        return (f"blocking {recv}.acquire()", True)
    if last == "wait" and recv is not None:
        return (f"{recv}.wait()", True)
    if last == "join":
        if isinstance(getattr(node.func, "value", None), ast.Constant):
            return None  # "sep".join(...)
        if q and q.startswith(("os.path", "posixpath", "ntpath")):
            return None
        if recv and _THREADISH.search(recv):
            return (f"{recv}.join()", True)
        return None
    if last in {"get", "put"} and recv and _QUEUEISH.search(recv):
        return (f"{recv}.{last}()", True)
    if last in {"accept", "recv", "recv_into", "sendall", "makefile"}:
        return (f"socket .{last}()", True)
    if last in {"connect", "create_connection"} and (
            q == "socket.create_connection"
            or (recv and _SOCKISH.search(recv))):
        return (f"{last}() dial", True)
    return None


@dataclass
class _Finding:
    kind: str
    lineno: int
    func: str
    detail: str


@dataclass
class _FnSummary:
    """Per-function bottom-up facts, closed under same-file calls."""

    blocks: str | None = None  # broad-set witness ("why"), or None
    signal_blocks: str | None = None  # narrow-set witness, or None
    acquires: dict = field(default_factory=dict)  # lock id -> lineno
    calls: set = field(default_factory=set)  # callee last-component names


class _FileScan:
    def __init__(self, src: str, filename: str):
        self.src_lines = src.splitlines()
        self.filename = filename
        self.tree = ast.parse(src, filename=filename)
        self.findings: list[_Finding] = []
        self.waived = 0
        self.guarded_fields = 0
        self.lock_edges: dict = {}  # (lockA, lockB) -> (lineno, func)
        # every def in the file (incl. methods and nested), name -> [nodes]
        self.defs_by_name: dict[str, list] = {}
        self.class_of_def: dict[int, str | None] = {}
        self.summaries: dict[int, _FnSummary] = {}
        self.class_names: list[str] = []
        self._collect_defs()

    # ------------------------------------------------------------- setup

    def _collect_defs(self):
        def walk(node, cls):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, ast.ClassDef):
                    self.class_names.append(child.name)
                    walk(child, child.name)
                elif isinstance(child, (ast.FunctionDef,
                                        ast.AsyncFunctionDef)):
                    self.defs_by_name.setdefault(child.name, []).append(child)
                    self.class_of_def[id(child)] = cls
                    walk(child, cls)
                else:
                    walk(child, cls)

        walk(self.tree, None)

    def _line_has(self, lineno: int, marker: str) -> bool:
        if 1 <= lineno <= len(self.src_lines):
            return marker in self.src_lines[lineno - 1]
        return False

    def _record(self, kind, lineno, func, detail, fn_waived=False):
        if self._line_has(lineno, PRAGMA) or fn_waived:
            self.waived += 1
            return
        self.findings.append(_Finding(kind, lineno, func, detail))

    # ---------------------------------------------------- lock identity

    def _lock_id(self, expr, cls: str | None) -> str | None:
        """Class-qualified name of a lock expression, or None if the
        expression doesn't look like a lock.  ``self._lock`` in class C
        → ``C._lock``; ``client._lock`` matches a same-file class by
        receiver-name containment (``client`` → ``ReplicaClient``)."""
        if isinstance(expr, ast.Name):
            return expr.id if _LOCKISH.search(expr.id) else None
        if not isinstance(expr, ast.Attribute):
            return None
        if not _LOCKISH.search(expr.attr):
            return None
        base = expr.value
        if isinstance(base, ast.Name):
            if base.id == "self" and cls is not None:
                return f"{cls}.{expr.attr}"
            for name in self.class_names:
                if base.id.lower().replace("_", "") in name.lower():
                    return f"{name}.{expr.attr}"
            return f"{base.id}.{expr.attr}"
        q = _qualname(expr)
        return q

    def _callee_name(self, call: ast.Call) -> str | None:
        """Name a call resolves to among same-file defs, or None.

        Bare-name calls resolve by name.  Attribute calls resolve only
        when the receiver plausibly IS an instance of a same-file class:
        ``self.x()`` / ``cls.x()`` always, ``recorder.dump()`` when some
        class name contains the receiver (``recorder`` →
        ``FlightRecorder``).  ``json.dump()`` must NOT resolve to a
        local ``dump`` method — module receivers match no class."""
        q = _qualname(call.func)
        if q is None:
            return None
        if isinstance(call.func, ast.Name):
            return q
        last = q.rsplit(".", 1)[-1]
        recv = _receiver_name(call.func)
        if recv in {"self", "cls"}:
            return last
        if recv is not None and len(recv) >= 3:
            probe = recv.lower().lstrip("_")
            for name in self.class_names:
                if probe in name.lower():
                    return last
        return None

    # ------------------------------------------------- function summaries

    def _direct_summary(self, fn) -> _FnSummary:
        s = _FnSummary()
        cls = self.class_of_def.get(id(fn))
        for node in _walk_own(fn):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    lid = self._lock_id(item.context_expr, cls)
                    if lid is not None:
                        s.acquires.setdefault(lid, node.lineno)
                        # entering `with <lock>` IS a blocking acquire on
                        # the narrow (signal-path) set; it is NOT a broad
                        # lock-blocking primitive — nested acquisition is
                        # the lock-order check's job, not this one's
                        if s.signal_blocks is None:
                            s.signal_blocks = f"blocking acquire of {lid}"
            if not isinstance(node, ast.Call):
                continue
            hit = _blocking_call(node)
            if hit is not None:
                reason, narrow = hit
                if s.blocks is None:
                    s.blocks = reason
                if narrow and s.signal_blocks is None:
                    s.signal_blocks = reason
                if reason.startswith("blocking ") and \
                        isinstance(node.func, ast.Attribute):
                    lid = self._lock_id(node.func.value, cls)
                    if lid is not None:
                        s.acquires.setdefault(lid, node.lineno)
            callee = self._callee_name(node)
            if callee is not None:
                s.calls.add(callee)
        return s

    def _compute_summaries(self):
        fns = [f for fl in self.defs_by_name.values() for f in fl]
        for fn in fns:
            self.summaries[id(fn)] = self._direct_summary(fn)
        # fixpoint: propagate through same-file, name-matched calls
        changed = True
        while changed:
            changed = False
            for fn in fns:
                s = self.summaries[id(fn)]
                for callee_name in s.calls:
                    for callee in self.defs_by_name.get(callee_name, ()):
                        if callee is fn:
                            continue
                        cs = self.summaries[id(callee)]
                        if cs.blocks is not None and s.blocks is None:
                            s.blocks = f"{callee_name}() → {cs.blocks}"
                            changed = True
                        if cs.signal_blocks is not None \
                                and s.signal_blocks is None:
                            s.signal_blocks = (
                                f"{callee_name}() → {cs.signal_blocks}"
                            )
                            changed = True
                        for lid, ln in cs.acquires.items():
                            if lid not in s.acquires:
                                s.acquires[lid] = ln
                                changed = True

    # ------------------------------------------------------- main passes

    def scan(self) -> list[_Finding]:
        self._compute_summaries()
        for name, fns in self.defs_by_name.items():
            for fn in fns:
                self._scan_fn(fn)
        self._scan_guards()
        self._scan_signal_handlers()
        return self.findings

    def _scan_fn(self, fn):
        """Lexical walk with the held-lock stack: blocking-under-lock
        findings and lock-graph edges."""
        cls = self.class_of_def.get(id(fn))
        fn_waived = self._line_has(fn.lineno, PRAGMA)
        held: list[str] = []

        def visit(node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return  # nested defs run later, not under these locks
            if isinstance(node, (ast.With, ast.AsyncWith)):
                pushed = []
                for item in node.items:
                    lid = self._lock_id(item.context_expr, cls)
                    if lid is not None:
                        self._note_acquire(lid, node.lineno, fn, held)
                        held.append(lid)
                        pushed.append(lid)
                for child in node.body:
                    visit(child)
                for _ in pushed:
                    held.pop()
                return
            if isinstance(node, ast.Call) and held:
                self._check_call_under_lock(node, fn, cls, held, fn_waived)
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in fn.body:
            visit(stmt)

    def _note_acquire(self, lid, lineno, fn, held):
        for h in held:
            if h != lid:
                self.lock_edges.setdefault(
                    (h, lid), (lineno, getattr(fn, "name", "<lambda>"))
                )

    def _check_call_under_lock(self, node, fn, cls, held, fn_waived):
        name = getattr(fn, "name", "<lambda>")
        hit = _blocking_call(node)
        if hit is not None:
            reason, _narrow = hit
            if reason.startswith("blocking ") and \
                    isinstance(node.func, ast.Attribute):
                lid = self._lock_id(node.func.value, cls)
                if lid is not None:
                    self._note_acquire(lid, node.lineno, fn, held)
            self._record(
                "lock-blocking", node.lineno, name,
                f"{reason} while holding {held[-1]} in `{name}` — every "
                f"waiter on that lock inherits the block",
                fn_waived=fn_waived,
            )
            return
        callee_name = self._callee_name(node)
        if callee_name is None:
            return
        for callee in self.defs_by_name.get(callee_name, ()):
            cs = self.summaries[id(callee)]
            if cs.blocks is not None:
                self._record(
                    "lock-blocking", node.lineno, name,
                    f"call to `{callee_name}` (which blocks: {cs.blocks}) "
                    f"while holding {held[-1]} in `{name}`",
                    fn_waived=fn_waived,
                )
                break
        else:
            return
        for callee in self.defs_by_name.get(callee_name, ()):
            for lid, ln in self.summaries[id(callee)].acquires.items():
                self._note_acquire(lid, node.lineno, fn, held)

    # --------------------------------------------------------- lock order

    def lock_order_findings(self) -> list[_Finding]:
        """Cycles in the per-file lock graph (ABBA shapes)."""
        graph: dict[str, set] = {}
        for (a, b) in self.lock_edges:
            graph.setdefault(a, set()).add(b)
            graph.setdefault(b, set())
        out = []
        seen_cycles = set()
        for start in sorted(graph):
            path, stack = [], [(start, iter(sorted(graph[start])))]
            on_path = {start}
            path.append(start)
            while stack:
                node, it = stack[-1]
                nxt = next(it, None)
                if nxt is None:
                    stack.pop()
                    on_path.discard(path.pop())
                    continue
                if nxt in on_path:
                    cyc = tuple(path[path.index(nxt):]) + (nxt,)
                    key = frozenset(cyc)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        lineno, func = self.lock_edges.get(
                            (cyc[0], cyc[1]), (0, "?")
                        )
                        out.append(_Finding(
                            "lock-order", lineno, func,
                            "lock-order cycle "
                            + " → ".join(cyc)
                            + " — two threads taking these in opposite "
                            "order deadlock; pick one global order",
                        ))
                    continue
                if nxt in graph and nxt not in on_path:
                    on_path.add(nxt)
                    path.append(nxt)
                    stack.append((nxt, iter(sorted(graph[nxt]))))
        return out

    # ------------------------------------------------------- guard checks

    def _guarded_map(self, cls_node) -> dict:
        """``field -> lock attr`` from annotated ``__init__`` lines."""
        out = {}
        for fn in cls_node.body:
            if not (isinstance(fn, ast.FunctionDef)
                    and fn.name == "__init__"):
                continue
            for node in ast.walk(fn):
                if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                    continue
                line = self.src_lines[node.lineno - 1] \
                    if node.lineno <= len(self.src_lines) else ""
                if GUARDED_BY not in line:
                    continue
                lock = line.split(GUARDED_BY, 1)[1].strip().split()[0]
                targets = node.targets if isinstance(node, ast.Assign) \
                    else [node.target]
                for t in targets:
                    if isinstance(t, ast.Attribute) and \
                            isinstance(t.value, ast.Name) and \
                            t.value.id == "self":
                        out[t.attr] = lock
        return out

    def _scan_guards(self):
        for cls_node in ast.walk(self.tree):
            if not isinstance(cls_node, ast.ClassDef):
                continue
            guarded = self._guarded_map(cls_node)
            if not guarded:
                continue
            self.guarded_fields += len(guarded)
            for fn in cls_node.body:
                if not isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                    continue
                if fn.name == "__init__" or fn.name.endswith("_locked"):
                    continue
                self._scan_guarded_writes(cls_node.name, fn, guarded)

    def _scan_guarded_writes(self, cls, fn, guarded):
        fn_waived = self._line_has(fn.lineno, PRAGMA)
        held: list[str] = []

        def self_field(expr) -> str | None:
            """``self.<field>`` or ``self.<field>[...]`` → field name."""
            if isinstance(expr, ast.Subscript):
                expr = expr.value
            if isinstance(expr, ast.Attribute) and \
                    isinstance(expr.value, ast.Name) and \
                    expr.value.id == "self" and expr.attr in guarded:
                return expr.attr
            return None

        def check_write(fieldname, lineno):
            lock = guarded[fieldname]
            if f"{cls}.{lock}" in held:
                return
            if self._line_has(lineno, f"{HOLDS} {lock}"):
                return
            self._record(
                "guard", lineno, fn.name,
                f"`self.{fieldname}` (guarded-by: {lock}) written in "
                f"`{fn.name}` without holding {cls}.{lock} — annotate the "
                f"line `# holds: {lock}` if the caller provably holds it",
                fn_waived=fn_waived,
            )

        def visit(node):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.Lambda)) and node is not fn:
                return
            if isinstance(node, (ast.With, ast.AsyncWith)):
                pushed = []
                for item in node.items:
                    lid = self._lock_id(item.context_expr, cls)
                    if lid is not None:
                        held.append(lid)
                        pushed.append(lid)
                for child in node.body:
                    visit(child)
                for _ in pushed:
                    held.pop()
                return
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    f = self_field(t)
                    if f is not None:
                        check_write(f, node.lineno)
            elif isinstance(node, ast.AugAssign):
                f = self_field(node.target)
                if f is not None:
                    check_write(f, node.lineno)
            elif isinstance(node, ast.Call) and \
                    isinstance(node.func, ast.Attribute) and \
                    node.func.attr in _MUTATORS:
                f = self_field(node.func.value)
                if f is not None:
                    check_write(f, node.lineno)
            for child in ast.iter_child_nodes(node):
                visit(child)

        for stmt in fn.body:
            visit(stmt)

    # ----------------------------------------------- signal-handler paths

    def _signal_handlers(self):
        """Defs registered via ``signal.signal(sig, handler)``."""
        out = []
        for node in ast.walk(self.tree):
            if not (isinstance(node, ast.Call)
                    and _qualname(node.func) == "signal.signal"
                    and len(node.args) >= 2):
                continue
            h = node.args[1]
            name = None
            if isinstance(h, ast.Name):
                name = h.id
            elif isinstance(h, ast.Attribute):
                name = h.attr  # self._handler → method name
            if name is None:
                continue
            for fn in self.defs_by_name.get(name, ()):
                out.append(fn)
        return out

    def _scan_signal_handlers(self):
        for fn in self._signal_handlers():
            fn_waived = self._line_has(fn.lineno, PRAGMA)
            s = self.summaries.get(id(fn))
            if s is None or s.signal_blocks is None:
                continue
            self._record(
                "signal-blocking", fn.lineno, fn.name,
                f"signal handler `{fn.name}` can block: {s.signal_blocks} "
                f"— a handler runs ON the interrupted thread, which may "
                f"hold the very lock/queue it would wait on (permanent "
                f"deadlock); use try-lock (`acquire(blocking=False)`) or "
                f"set-a-flag-and-return",
                fn_waived=fn_waived,
            )


def _walk_own(fn):
    """Walk ``fn``'s body without descending into nested defs."""
    stack = list(
        ast.iter_child_nodes(fn)
        if not isinstance(fn, ast.Lambda)
        else [fn.body]
    )
    while stack:
        node = stack.pop()
        yield node
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.Lambda)):
            continue
        stack.extend(ast.iter_child_nodes(node))


def scan_source(src: str, filename: str = "<string>"):
    """Lint one source blob; returns ``(violations, detail)`` where
    detail carries the waived count, guarded-field count, and the file's
    lock edges (for the whole-tree graph report)."""
    scan = _FileScan(src, filename)
    findings = scan.scan()
    findings += scan.lock_order_findings()
    out = [
        Violation(
            "concurrency", f.kind, f"{filename}:{f.lineno}", f.detail,
            src=f.lineno,
        )
        for f in findings
    ]
    return out, {
        "waived": scan.waived,
        "guarded_fields": scan.guarded_fields,
        "lock_edges": sorted(
            f"{a} → {b}" for a, b in scan.lock_edges
        ),
    }


def scan_file(path: str, rel: str | None = None):
    with open(path, encoding="utf-8") as fh:
        src = fh.read()
    return scan_source(src, rel or path)


def run_concurrency_lint(
    root: str | None = None, programs=None, times: dict | None = None
):
    """Lint every ``.py`` file under ``root`` (default: this package,
    ``flextree_tpu_torch/``); ``programs`` filters by path substring,
    ``times`` collects per-package wall-times (grouped by subpackage)."""
    import time as _time

    if root is None:
        root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    base = os.path.dirname(os.path.abspath(root))
    violations: list[Violation] = []
    detail: dict = {
        "files_scanned": 0, "waived": 0, "guarded_fields": 0,
        "lock_edges": [],
    }
    edges: set = set()
    for dirpath, dirnames, filenames in os.walk(root):
        dirnames[:] = [d for d in dirnames if d != "__pycache__"]
        for fname in sorted(filenames):
            if not fname.endswith(".py"):
                continue
            path = os.path.join(dirpath, fname)
            rel = os.path.relpath(path, base)
            if programs and not any(p in rel for p in programs):
                continue
            t0 = _time.perf_counter()
            vs, d = scan_file(path, rel)
            violations += vs
            detail["files_scanned"] += 1
            detail["waived"] += d["waived"]
            detail["guarded_fields"] += d["guarded_fields"]
            edges.update(d["lock_edges"])
            if times is not None:
                pkg = os.path.dirname(rel) or rel
                times[pkg] = round(
                    times.get(pkg, 0.0)
                    + (_time.perf_counter() - t0) * 1e3, 1
                )
    detail["lock_edges"] = sorted(edges)
    return violations, detail
