"""The port's concurrency lint (``analysis/concurrency_lint.py``) against
the JAX package's.

Every fixture of the JAX suite's concurrency-lint units
(``tests/test_control_plane_analysis.py``, ``TestConcurrencyLintFixtures``)
runs through both scanners: the same ``(kind, line)`` findings, waived
count, guarded fields and lock edges.  Both scanners over the JAX
package's own tree agree apart from the device-sync rule, whose names
differ by design (``block_until_ready``/``device_get`` there; the host's
waits on the card here), and each torch device-sync call under a lock is
flagged.  Over ``flextree_tpu_torch/`` the lint reports no violation,
and every waiver carries a reason.
"""

from __future__ import annotations

import os
import re

import pytest
import test_control_plane_analysis as jtests

from flextree_tpu.analysis import concurrency_lint as j_lint
from flextree_tpu_torch.analysis import concurrency_lint as lint

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = sorted(name for name in dir(jtests.TestConcurrencyLintFixtures)
                  if name.startswith("test_"))


def view(result):
    violations, detail = result
    return (sorted((v.kind, v.src, v.detail) for v in violations),
            detail["waived"], detail["guarded_fields"], detail["lock_edges"])


def test_the_jax_suite_has_its_fixtures():
    assert len(FIXTURES) == 11


@pytest.mark.parametrize("name", FIXTURES)
def test_jax_fixture_gives_jax_findings(name, monkeypatch):
    seen = []

    def both(src, filename="<string>"):
        theirs = j_lint.scan_source(src, filename)
        seen.append((src, view(theirs), view(lint.scan_source(src,
                                                                filename))))
        return theirs

    monkeypatch.setattr(jtests, "scan_source", both)
    getattr(jtests.TestConcurrencyLintFixtures(), name)()
    assert seen
    for src, theirs, ours in seen:
        assert ours == theirs, src


def _device_sync(detail: str) -> bool:
    return "device sync" in detail


def test_both_scanners_agree_over_the_jax_tree():
    root = os.path.join(ROOT, "flextree_tpu")
    theirs = j_lint.run_concurrency_lint(root=root)
    ours = lint.run_concurrency_lint(root=root)

    def findings(result):
        return sorted((v.kind, v.where, v.detail) for v in result[0]
                      if not _device_sync(v.detail))

    assert findings(ours) == findings(theirs)
    for key in ("files_scanned", "waived", "guarded_fields", "lock_edges"):
        assert ours[1][key] == theirs[1][key], key
    assert ours[1]["files_scanned"] > 50


SYNC_CALLS = (
    ("torch.cuda.synchronize()", ".synchronize() device sync"),
    ("self._event.synchronize()", ".synchronize() device sync"),
    ("stream.synchronize()", ".synchronize() device sync"),
    ("x.item()", ".item() device sync"),
    ("x.cpu()", ".cpu() device sync"),
    ("x.tolist()", ".tolist() device sync"),
)


@pytest.mark.parametrize("call,why", SYNC_CALLS)
def test_each_torch_device_sync_under_a_lock_is_flagged(call, why):
    src = ("import torch\n"
           "class S:\n"
           "    def f(self, x, stream):\n"
           "        with self._lock:\n"
           f"            return {call}\n"
           "    def g(self, x, stream):\n"
           f"        return {call}\n")
    violations, _ = lint.scan_source(src)
    assert [(v.kind, v.src) for v in violations] == [("lock-blocking", 5)]
    assert why in violations[0].detail
    # the JAX rule does not know the card's waits
    assert j_lint.scan_source(src)[0] == []
    # a waiver with its reason, and a helper that syncs, reached under
    # the lock through a same-file call
    waived = src.replace(f"return {call}\n    def g",
                         f"return {call}  # {lint.PRAGMA} — fixture\n"
                         "    def g", 1)
    vs, detail = lint.scan_source(waived)
    assert vs == [] and detail["waived"] == 1
    through = ("import torch\n"
               "def pull(x, stream):\n"
               f"    return {call}\n"
               "class S:\n"
               "    def f(self, x, stream):\n"
               "        with self._lock:\n"
               "            return pull(x, stream)\n")
    assert [v.kind for v in lint.scan_source(through)[0]] == ["lock-blocking"]


def test_items_and_module_calls_are_not_device_syncs():
    src = ("import numpy as np\n"
           "class S:\n"
           "    def f(self, d):\n"
           "        with self._lock:\n"
           "            return list(d.items()), np.asarray(d).sum()\n")
    assert lint.scan_source(src)[0] == []


def test_the_port_is_clean_and_every_waiver_has_a_reason():
    violations, detail = lint.run_concurrency_lint()
    assert violations == [], "\n".join(str(v) for v in violations)
    assert detail["files_scanned"] > 90
    assert detail["guarded_fields"] >= 20
    pkg = os.path.join(ROOT, "flextree_tpu_torch")
    waivers = 0
    for dirpath, _, files in os.walk(pkg):
        for fname in files:
            if not fname.endswith(".py") or fname == "concurrency_lint.py":
                continue
            with open(os.path.join(dirpath, fname), encoding="utf-8") as f:
                for line in f:
                    if lint.PRAGMA in line:
                        waivers += 1
                        assert re.search(re.escape(lint.PRAGMA)
                                         + r"\s*[—-]+\s*\S", line), line
    assert waivers == detail["waived"] >= 1
    only, d = lint.run_concurrency_lint(programs=["serving/frontdoor"])
    assert only == [] and d["files_scanned"] == 1
