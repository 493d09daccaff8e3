"""Command-line tools of the port: ``python -m
flextree_tpu_torch.tools.calibrate_host`` fits the planner's cost-model
constants on the backend it runs on; ``...tools.feedback_convergence`` and
``...tools.probe_free_feedback`` run the closed-loop planner feedback end
to end, with probes and without; ``...tools.arbiter_spike`` shares one
device between a trainer and a serving pool under the chip arbiter, and
``...tools.coord_chaos`` runs the coordinated control plane under kills,
stops, torn files and a gloo wire."""

from __future__ import annotations

import fnmatch
import os
import tempfile

#: result files the repository commits (the JAX package's measurements):
#: the port's tools never write them
COMMITTED_RESULTS = ("FEEDBACK.json", "OBS_ATTRIBUTION.json", "BENCH_*.json")


def committed(path: str) -> bool:
    """Whether ``path`` names one of :data:`COMMITTED_RESULTS`."""
    name = os.path.basename(path)
    return any(fnmatch.fnmatch(name, pat) for pat in COMMITTED_RESULTS)


def checked_out(parser, path: str) -> str:
    """``path`` as a tool's ``--out``, or ``parser.error``: never one of
    :data:`COMMITTED_RESULTS`, and only under ``tmp/`` of the working
    directory or the system's temporary directory.  Its directory is
    made."""
    if committed(path):
        parser.error(f"--out {path}: a committed result of the JAX "
                     f"package; write the port's under tmp/")
    real = os.path.realpath(path)
    roots = [os.path.realpath("tmp"), os.path.realpath(tempfile.gettempdir())]
    if not any(real.startswith(r + os.sep) for r in roots):
        parser.error(f"--out {path}: write under tmp/ (or {roots[1]})")
    os.makedirs(os.path.dirname(real), exist_ok=True)
    return real
