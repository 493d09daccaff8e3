"""Planner CLI: ``python -m flextree_tpu_torch.planner --n 16 --size-mb 256``.

The port's copy of ``flextree_tpu/planner/__main__.py``, flag for flag:
the offline entry point mirroring the reference's ``cost_model`` binary
(``cost_model/main.cpp``): enumerate candidate tree shapes for N devices,
cost each, print the ranked table and the winning ``FT_TOPO`` value.
``--sweep`` reproduces the reference's N=1..max sweep (shape counts +
planning time per N, CSV to stdout).  ``--ir-families`` adds swing and the
generalized shapes to the table.  ``--calibration F`` prices with the
section of F that ``python -m flextree_tpu_torch.tools.calibrate_host``
fitted for this backend and ``--n`` ranks.  ``--native`` (the C++ core) is
not ported.
"""

from __future__ import annotations

import argparse
import sys
import time

from .choose import choose_topology
from .cost_model import TpuCostParams, LinkParams
from .factorize import count_ordered_factorizations

_NATIVE = "ROADMAP.md, Queue 1: '`schedule/native.py`'"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        prog="flextree_tpu_torch.planner",
        description="Choose the cheapest allreduce tree shape for N devices.",
    )
    ap.add_argument("--n", type=int, default=None, help="device count")
    ap.add_argument("--size-mb", type=float, default=256.0, help="payload MB per chip")
    ap.add_argument(
        "--mesh-shape",
        type=str,
        default=None,
        help="physical torus shape, e.g. 16,16 (enables torus-aligned costing)",
    )
    ap.add_argument(
        "--dcn-axes",
        type=str,
        default="",
        help="comma list of mesh-axis indices that are DCN (multi-slice)",
    )
    ap.add_argument("--ici-gbps", type=float, default=45.0)
    ap.add_argument("--ici-latency-us", type=float, default=1.0)
    ap.add_argument(
        "--calibration",
        type=str,
        default=None,
        metavar="PATH",
        help="calibration file with measured cost constants (see "
        "planner/calibrate.py); overrides --ici-* when its section exists "
        "and was fitted on this backend at --n ranks",
    )
    ap.add_argument(
        "--backend",
        type=str,
        default="cuda",
        help="which calibration section to load (cuda, cpu, ...)",
    )
    ap.add_argument(
        "--sweep",
        type=int,
        default=None,
        metavar="NMAX",
        help="sweep N=2..NMAX, print CSV (n, num_shapes, chosen, plan_us)",
    )
    ap.add_argument(
        "--native",
        action="store_true",
        help="use the native C++ core (not ported)",
    )
    ap.add_argument(
        "--ir-families",
        action="store_true",
        help="also rank swing and the generalized shapes",
    )
    args = ap.parse_args(argv)
    if args.native:
        raise NotImplementedError(
            f"the native planner core is not ported yet ({_NATIVE})")

    params = TpuCostParams(
        ici=LinkParams(bandwidth_GBps=args.ici_gbps, latency_us=args.ici_latency_us)
    )
    if args.calibration:
        from .calibrate import backend_fingerprint, load_calibration

        cal = load_calibration(
            args.calibration, backend=args.backend,
            fingerprint=backend_fingerprint(args.backend, ranks=args.n))
        if cal is None:
            print(
                f"no {args.backend!r} section in {args.calibration}; "
                "using CLI/default constants",
                file=sys.stderr,
            )
        else:
            params = cal
    nbytes = int(args.size_mb * 1e6)

    if args.sweep is not None:
        print("n,num_shapes,chosen,plan_us")
        for n in range(2, args.sweep + 1):
            t0 = time.perf_counter()
            plan = choose_topology(n, nbytes, params)
            widths = plan.widths
            lonely = getattr(plan.topology, "lonely", 0)
            dt = (time.perf_counter() - t0) * 1e6
            shape = "ring" if widths == (1,) else "*".join(map(str, widths))
            if lonely:
                shape += f"+{lonely}"
            print(f"{n},{count_ordered_factorizations(n)},{shape},{dt:.1f}")
        return 0

    if args.n is None:
        ap.error("--n is required unless --sweep is given")

    mesh_shape = (
        tuple(int(t) for t in args.mesh_shape.split(",")) if args.mesh_shape else None
    )
    dcn_axes = (
        tuple(int(t) for t in args.dcn_axes.split(",")) if args.dcn_axes else ()
    )
    plan = choose_topology(
        args.n, nbytes, params, mesh_shape=mesh_shape, dcn_axes=dcn_axes,
        ir_families=("swing", "generalized") if args.ir_families else (),
    )
    print(plan.summary())
    print(f"FT_TOPO={plan.to_ft_topo()}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
