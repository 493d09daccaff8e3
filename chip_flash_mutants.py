#!/usr/bin/env python3
"""Mutation check of the bfloat16 parity bars, on one NVIDIA GPU.

    python3 chip_flash_mutants.py

Phase 7 of ``chip_smoke.py`` holds each flash kernel in bfloat16 to its
plain version within ``BF16_PEAK`` and ``BF16_RMS``, and phase 2 the
paged-decode kernel within ``PAGED_BF16_PEAK`` and ``PAGED_BF16_RMS``.
This script shows that the bars tell kernels that keep the TPU kernels'
rounding points from kernels that move one.  It copies
``flextree_tpu_torch/csrc`` into a temporary directory once per mutant,
changes one rounding point there, builds the copy, and runs phase 7's
bfloat16 cases (flash mutants) or phase 2's bfloat16 rows (paged
mutants) through the kernels of the checkout and through each mutant:

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
- ``dq_ds``: ds enters ``ds @ k`` as two bf16 terms, not rounded to k's
  dtype (flash_bwd_dq.cu, the tensor-core kernel);
- ``dq_prescale``: q not pre-scaled in bf16 in dq; the factor multiplies
  the float32 scores instead (flash_bwd_dq.cu);
- ``paged_score``: each score not rounded to the storage dtype before the
  float32 scale (paged_attention.cu);
- ``paged_partial``: the split partials' acc and l rounded to bf16
  (paged_attention.cu).

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
    "dq_ds": ("flash_bwd_dq.cu", (("constexpr int kDsTerms = 1;",
                                    "constexpr int kDsTerms = 2;"),)),
    "dq_prescale": ("flash_bwd_dq.cu", (
        ("prescale_tile<DM>(sq, qmul_b);", "prescale_tile<DM>(sq, 1.f);"),
        ("fast_exp2(s[n][e] - lse2[", "fast_exp2(s[n][e] * qmul_b - lse2["))),
    "paged_score": ("paged_attention.cu", (
        ("sc[i * bs + j] = round_to_storage<T>(part) * scale;",
         "sc[i * bs + j] = part * scale;"),)),
    "paged_partial": ("paged_attention.cu", (
        ("ws[part_at * D + d] = a;",
         "ws[part_at * D + d] = round_to_storage<T>(a);"),
        ("ml[2 * part_at + 1] = lsum;",
         "ml[2 * part_at + 1] = round_to_storage<T>(lsum);"))),
}
FLASH = ("flash_fwd", "flash_bwd_dq", "flash_bwd_dkv")
PAGED = ("paged_attention",)


def kernels_of(tag):
    """The kernels a build runs: the checkout's all, a mutant's those its
    check covers."""
    if tag == "checkout":
        return FLASH + PAGED
    return PAGED if MUTANTS[tag][0] == "paged_attention.cu" else FLASH


def use_sources(kernels, csrc: Path, build_dir: Path, names) -> None:
    """Point the kernel loader at the sources of ``names`` under ``csrc``
    and build them into ``build_dir`` (one ``nvcc`` per source,
    together)."""
    kernels.SOURCES = {n: csrc / f"{n}.cu" for n in names}
    kernels.HEADERS = sorted(csrc.glob("*.cuh"))
    kernels.BUILD_DIR = build_dir
    kernels._loaded.clear()
    kernels.build(names)


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


def check_paged(smoke, pa, dev, tag):
    """Phase 2's bfloat16 rows through the loaded paged kernel: ``{row:
    failures}`` and ``{reference: (largest peak, largest rms)}``."""
    gen = torch.Generator().manual_seed(smoke.SEED)
    failed, worst = {}, {}
    for lengths in smoke.paged_rows():
        errs, failures = smoke.paged_compare(pa, torch.bfloat16, lengths,
                                             dev, gen)
        if failures:
            failed[str(lengths)] = failures
        for key, e in errs.items():
            p, r = worst.get(key, (0.0, 0.0))
            worst[key] = (max(p, e["peak"]), max(r, e["rms"]))
        smoke.log(f"{tag} paged bf16 lengths {lengths}: "
                  f"{smoke.describe_errors(errs)}"
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
    from flextree_tpu_torch.ops import paged_attention as pa

    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smoke.log(f"device: {smoke.smi_line()}; flash bar: peak "
              f"{smoke.BF16_PEAK:.3g}, rms {smoke.BF16_RMS:.3g}, lse "
              f"{smoke.LSE_TOL:.3g}; paged bar: peak "
              f"{smoke.PAGED_BF16_PEAK:.3g}, rms {smoke.PAGED_BF16_RMS:.3g}")
    csrc = Path(HERE) / "flextree_tpu_torch" / "csrc"
    summary = {"bar": {"peak": smoke.BF16_PEAK, "rms": smoke.BF16_RMS,
                       "lse": smoke.LSE_TOL,
                       "paged_peak": smoke.PAGED_BF16_PEAK,
                       "paged_rms": smoke.PAGED_BF16_RMS}, "builds": {}}
    with tempfile.TemporaryDirectory(prefix="ft-mutants-") as tmp:
        for tag in ("checkout", *MUTANTS):
            src = csrc if tag == "checkout" else mutate(
                csrc, Path(tmp) / tag / "csrc", tag)
            names = kernels_of(tag)
            use_sources(kernels, src, Path(tmp) / tag / "build", names)
            failed, worst = {}, {}
            if names != PAGED:
                failed, worst = check(smoke, fa, dev, tag)
            if names != FLASH:
                p_failed, p_worst = check_paged(smoke, pa, dev, tag)
                failed.update(p_failed)
                worst.update({f"paged {k}": v for k, v in p_worst.items()})
            summary["builds"][tag] = {"failed": failed, "worst": worst}
    real = summary["builds"]["checkout"]["failed"]
    caught = {m: bool(summary["builds"][m]["failed"]) for m in MUTANTS}
    summary["ok"] = not real and all(caught.values())
    for tag, b in summary["builds"].items():
        smoke.log(f"{tag}: fails {len(b['failed'])} cases; worst (peak, "
                  f"rms) "
                  + ", ".join(f"{k} ({p:.3g}, {r:.3g})"
                              for k, (p, r) in b["worst"].items()))
    print(json.dumps(summary), flush=True)
    return 0 if summary["ok"] else 1


if __name__ == "__main__":
    raise SystemExit(main())
