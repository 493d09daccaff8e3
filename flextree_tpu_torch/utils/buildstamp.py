"""Git build stamping: make every artifact traceable to a commit.

The port's copy of ``flextree_tpu/utils/buildstamp.py``.  The reference
bakes ``GIT_REPO_VERSION/DATE/HASH`` defines into its binary at build
time (``allreduce_over_mpi/CMakeLists.txt:10-31``) and prints them under
``--version`` (``benchmark.cpp:109-115``).  Python has no build step, so
the stamp is resolved at first use from the repo the port is imported
from, and cached for the process lifetime.

Outside a git checkout (an installed wheel, an exported tree) every git
field degrades to ``"unknown"``: the stamp never raises.
"""

from __future__ import annotations

import datetime
import functools
import os
import subprocess

__all__ = ["artifact_meta", "build_info", "version_string"]


def _git(*args: str) -> str:
    """One git query against the port's repo; '' on any failure."""
    repo_dir = os.path.dirname(os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    try:
        out = subprocess.run(("git", "-C", repo_dir, *args),
                             capture_output=True, text=True, timeout=10)
    except (OSError, subprocess.TimeoutExpired):
        return ""
    return out.stdout.strip() if out.returncode == 0 else ""


@functools.lru_cache(maxsize=1)
def build_info() -> dict:
    """Version and git provenance, the reference's three stamps.

    Keys: ``version`` (the port's ``__version__``), ``git_hash`` (short),
    ``git_date`` (commit ISO date), ``git_describe`` (``git describe
    --always --dirty``).  Git fields are ``"unknown"`` outside a checkout.
    """
    from .. import __version__

    return {
        "version": __version__,
        "git_hash": _git("rev-parse", "--short", "HEAD") or "unknown",
        "git_date": _git("log", "-1", "--format=%cI") or "unknown",
        "git_describe": _git("describe", "--always", "--dirty") or "unknown",
    }


def version_string() -> str:
    """One-line ``--version`` text (the ``benchmark.cpp:109-115`` analog)."""
    info = build_info()
    return (f"flextree-tpu-torch {info['version']} "
            f"(git {info['git_describe']}, committed {info['git_date']})")


def artifact_meta() -> dict:
    """Provenance block for a result file: :func:`build_info` and the
    generation time, so two results of one commit stay distinguishable."""
    meta = dict(build_info())
    meta["generated_at"] = datetime.datetime.now(
        datetime.timezone.utc).isoformat(timespec="seconds")
    return meta
