#!/usr/bin/env python3
"""Mutation check of the bfloat16 flash parity bar, on one NVIDIA GPU.

    python3 chip_flash_mutants.py

Phase 7 of ``chip_smoke.py`` holds each flash kernel in bfloat16 to its
plain version within ``BF16_PEAK`` and ``BF16_RMS``.  This script shows
that the bar tells kernels that keep the TPU kernels' rounding points from
kernels that drop one.  It copies ``flextree_tpu_torch/csrc`` into a
temporary directory once per mutant, removes one rounding point there (or,
for ``dkv_p``, adds one), builds the copy, and runs phase 7's bfloat16
cases through the kernels of the checkout and through each mutant:

- ``fwd_p``: p enters ``p @ v`` as two bf16 terms, not rounded to v's
  dtype (flash_fwd.cu, the tensor-core kernel);
- ``fwd_prescale``: q not pre-scaled in bf16; the ``scale * log2(e)``
  factor multiplies the float32 scores instead (flash_fwd.cu);
- ``dkv_prescale``: the same for k in dk/dv (flash_bwd_dkv.cu);
- ``dkv_ds``: ds enters ``ds^T @ q`` as two bf16 terms, not rounded to
  q's dtype (flash_bwd_dkv.cu);
- ``dkv_p``: p enters ``p^T @ do`` as one bf16 term, where the TPU kernel
  takes it in float32 (flash_bwd_dkv.cu: the two remainder terms
  dropped);
- ``dq_ds``: ds not rounded to k's dtype before ``ds @ k``
  (flash_bwd_dq.cu, whose bfloat16 path is still the float32-core
  kernel);
- ``dq_prescale``: the pre-scale of q in dq not rounded to the input
  dtype (flash_common.cuh's ``load_tile``, which only that kernel's
  bfloat16 path still uses).

Prints one line per build and case with each comparison's errors, and
last a JSON summary.  Exits 0 only when the checkout's kernels pass every
case and every mutant fails at least one.
"""

from __future__ import annotations

import json
import os
import shutil
import sys
import tempfile
from pathlib import Path

import torch

HERE = os.path.dirname(os.path.abspath(__file__))

# mutant: (file under csrc, ((text as written, text of the mutant), ...))
MUTANTS = {
    "fwd_p": ("flash_fwd.cu", (("constexpr int kPTerms = 1;",
                                "constexpr int kPTerms = 2;"),)),
    "fwd_prescale": ("flash_fwd.cu", (
        ("prescale_tile<DM>(sq, qmul_b);", "prescale_tile<DM>(sq, 1.f);"),
        ("    // mask by position (the full tiles below kb_full skip it)\n",
         "    for (int n = 0; n < NS; ++n)\n"
         "      for (int e = 0; e < 4; ++e) sc[n][e] *= qmul_b;\n"))),
    "dkv_prescale": ("flash_bwd_dkv.cu", (
        ("prescale_tile<DM>(sk, kmul_b);", "prescale_tile<DM>(sk, 1.f);"),
        ("fast_exp2(st[n][e] - lse2[", "fast_exp2(st[n][e] * kmul_b - lse2["))),
    "dkv_ds": ("flash_bwd_dkv.cu", (("constexpr int kDsTerms = 1;",
                                     "constexpr int kDsTerms = 2;"),)),
    "dkv_p": ("flash_bwd_dkv.cu", (("constexpr int kPTerms = 3;",
                                    "constexpr int kPTerms = 1;"),)),
    "dq_ds": ("flash_bwd_dq.cu", (("= round_to<E>(ds);", "= ds;"),)),
    "dq_prescale": ("flash_common.cuh", (("x = round_to<E>(x * mul);",
                                          "x = x * mul;"),)),
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")


def use_sources(kernels, csrc: Path, build_dir: Path) -> None:
    """Point the kernel loader at the flash sources under ``csrc`` and
    build them into ``build_dir`` (one ``nvcc`` per source, together)."""
    kernels.SOURCES = {n: csrc / f"{n}.cu" for n in FLASH}
    kernels.HEADERS = sorted(csrc.glob("*.cuh"))
    kernels.BUILD_DIR = build_dir
    kernels._loaded.clear()
    kernels.build(FLASH)


def mutate(csrc: Path, dst: Path, mutant: str) -> Path:
    """A copy of ``csrc`` at ``dst`` with ``mutant``'s edits made; each
    edited text must occur in its file exactly once."""
    shutil.copytree(csrc, dst)
    name, edits = MUTANTS[mutant]
    path = dst / name
    text = path.read_text()
    for old, new in edits:
        if text.count(old) != 1:
            raise RuntimeError(f"{mutant}: {old!r} is not in {name} "
                               f"exactly once")
        text = text.replace(old, new)
    path.write_text(text)
    return dst


def check(smoke, fa, dev, tag):
    """Phase 7's bfloat16 cases through the loaded kernels: ``{case:
    failures}`` and ``{key: (largest peak, largest rms)}``."""
    gen = torch.Generator().manual_seed(smoke.SEED + 2)
    failed, worst = {}, {}
    for case in smoke.FLASH_CASES:
        errs, failures, note, run = smoke.flash_compare(
            fa, case, torch.bfloat16, dev, gen)
        del run
        torch.cuda.empty_cache()
        if failures:
            failed[case[0]] = failures
        for key, e in errs.items():
            if "peak" in e:
                p, r = worst.get(key, (0.0, 0.0))
                worst[key] = (max(p, e["peak"]), max(r, e["rms"]))
        smoke.log(f"{tag} {smoke.describe_case(case, 'bf16')}: "
                  f"{smoke.describe_errors(errs)}; {note}"
                  f"{'; FAILS ' + '; '.join(failures) if failures else ''}")
    return failed, worst


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_flash_mutants: no CUDA device is available",
              file=sys.stderr)
        return 2
    sys.path.insert(0, HERE)
    import chip_smoke as smoke
    from flextree_tpu_torch import kernels
    from flextree_tpu_torch.ops import flash_attention as fa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smoke.log(f"device: {smoke.smi_line()}; bar: peak {smoke.BF16_PEAK:.3g}, "
              f"rms {smoke.BF16_RMS:.3g}, lse {smoke.LSE_TOL:.3g}")
    csrc = Path(HERE) / "flextree_tpu_torch" / "csrc"
    summary = {"bar": {"peak": smoke.BF16_PEAK, "rms": smoke.BF16_RMS,
                       "lse": smoke.LSE_TOL}, "builds": {}}
    with tempfile.TemporaryDirectory(prefix="ft-mutants-") as tmp:
        for tag in ("checkout", *MUTANTS):
            src = csrc if tag == "checkout" else mutate(
                csrc, Path(tmp) / tag / "csrc", tag)
            use_sources(kernels, src, Path(tmp) / tag / "build")
            failed, worst = check(smoke, fa, dev, tag)
            summary["builds"][tag] = {"failed": failed, "worst": worst}
    real = summary["builds"]["checkout"]["failed"]
    caught = {m: bool(summary["builds"][m]["failed"]) for m in MUTANTS}
    summary["ok"] = not real and all(caught.values())
    for tag, b in summary["builds"].items():
        smoke.log(f"{tag}: fails {len(b['failed'])}/"
                  f"{len(smoke.FLASH_CASES)} cases; worst (peak, rms) "
                  + ", ".join(f"{k} ({p:.3g}, {r:.3g})"
                              for k, (p, r) in b["worst"].items()))
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
