"""Fit the planner's cost-model constants on this backend and save them.

    python -m flextree_tpu_torch.tools.calibrate_host --out CAL.json
    python -m flextree_tpu_torch.tools.calibrate_host --device cpu --out CAL.json

PyTorch counterpart of the JAX package's ``tools/calibrate_host.py``: time
the FlexTree allreduce at every (topology, size) point of a matrix on an
in-process mesh of 8 ranks (``planner.calibrate.measure_points``,
the benchmark harness's in-place protocol, every point checked correct),
fit the cost model's four constants (``fit_cost_params``, relative NNLS),
and write them as the ``cuda`` section (``cpu`` with ``--device cpu``) of
the calibration file ``--out`` (default: ``$FLEXTREE_CALIBRATION``),
stamped with the backend's fingerprint: the device, the device count, the
transport (``mesh``), the rank count and the torch version.  Prints the
constants, each point's measured median and noise beside the fit's
prediction, and the Spearman rank correlation of the two.

On the card each timed call is enqueued while the card spins, so the
times are the card's work (its launches, copies and folds) and not the
host's dispatch of them, which today takes longer than the work at every
size of the matrix; ``--wall`` times the call as the bench does instead.

The default matrix is the JAX tool's topologies (``8``, ``4,2``,
``2,2,2``, ``2,4``, the ring ``1``) over 2^14, 2^17, 2^20 and 2^22 float32
elements a rank.  ``choose_topology``, ``default_params`` and ``python -m
flextree_tpu_torch.planner --calibration F`` read the file.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import platform
import subprocess

TOPOS = ("8", "4,2", "2,2,2", "2,4", "1")
SIZES = (1 << 14, 1 << 17, 1 << 20, 1 << 22)


def smi_line() -> str | None:
    """The card's name and power limit as ``nvidia-smi`` gives them."""
    try:
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=60, check=True).stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        return None


def calibrate(out: str, *, device: str | None = None, ranks: int = 8,
              topos=TOPOS, sizes=SIZES, repeat: int = 10,
              wall: bool = False) -> dict:
    """Measure, fit and save one section; returns what it wrote and the
    points beside their predictions."""
    import torch

    from ..device import resolve_device
    from ..planner import (
        backend_fingerprint,
        fit_cost_params,
        measure_points,
        predict_us,
        save_calibration,
        spearman,
    )
    from ..planner.calibrate import _params_to_dict

    dev = resolve_device(device)
    device_time = dev.type == "cuda" and not wall
    points = measure_points(list(topos), list(sizes), repeat=repeat,
                            devices=ranks, device=str(dev),
                            device_time=device_time)
    params = fit_cost_params(points)
    predicted = [predict_us(params, p.widths, p.num_nodes, p.nbytes)
                 for p in points]
    rho = spearman(predicted, [p.measured_us for p in points])
    fingerprint = backend_fingerprint(dev, ranks=ranks, transport="mesh")
    name = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    save_calibration(
        out, params, backend=dev.type, fingerprint=fingerprint,
        source="measured",
        meta={
            "date": datetime.date.today().isoformat(),
            "host": platform.platform(),
            "device": name,
            "nvidia_smi": smi_line() if dev.type == "cuda" else None,
            "torch": torch.__version__,
            "protocol": "fit_cost_params (relative NNLS) over "
            f"{len(points)} in-place-timed points on an in-process mesh of "
            f"{ranks} ranks: topos={list(topos)}, sizes={list(sizes)}, "
            f"repeat={repeat}, median stat, "
            + ("device time (calls enqueued ahead of the card)"
               if device_time else "wall time (CUDA events or host clock)"),
            "spearman": rho,
        },
    )
    return {
        "backend": dev.type, "fingerprint": fingerprint,
        "device_time": device_time,
        "params": _params_to_dict(params), "spearman": rho,
        "points": [{"widths": list(p.widths), "nbytes": p.nbytes,
                    "measured_us": p.measured_us, "noise_us": p.noise_us,
                    "predicted_us": q} for p, q in zip(points, predicted)],
    }


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="flextree_tpu_torch.tools.calibrate_host")
    ap.add_argument("--out", default=os.environ.get("FLEXTREE_CALIBRATION"),
                    help="calibration file to write or merge into "
                    "(default: $FLEXTREE_CALIBRATION)")
    ap.add_argument("--device", default=None, help="cuda (default) or cpu")
    ap.add_argument("--wall", action="store_true",
                    help="time the call as the bench does, host dispatch "
                    "included, not the card's work alone")
    args = ap.parse_args(argv)
    if not args.out:
        ap.error("name the calibration file: --out or $FLEXTREE_CALIBRATION")
    res = calibrate(args.out, device=args.device, wall=args.wall)
    print(json.dumps(res))
    print(f"wrote the {res['backend']} section of {args.out}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
