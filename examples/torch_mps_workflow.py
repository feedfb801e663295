"""MPS file workflow on the PyTorch/CUDA port (``ssqp_tpu_torch``), the
twin of examples/mps_workflow.py (reference: examples/rwMOI.jl — read a
problem file, hand it to the solver through the modeling layer, inspect
the results), with dual certificates on top (a capability the reference
lacks, MOIwrapper.jl:255-257).

Run: python examples/torch_mps_workflow.py          (on the card)
     python examples/torch_mps_workflow.py --cpu    (on the CPU)
"""

import argparse
import pathlib
import sys

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]))

import numpy as np

import ssqp_tpu_torch as ssqp

DATA = pathlib.Path(__file__).resolve().parents[1] / "tests" / "data"


def device_arg(argv, doc):
    """'cpu' under --cpu, else 'cuda'."""
    ap = argparse.ArgumentParser(description=doc.splitlines()[0])
    ap.add_argument("--cpu", action="store_true",
                    help="run on the CPU instead of the card")
    return "cpu" if ap.parse_args(argv).cpu else "cuda"


def main(argv=None):
    dev = device_arg(argv, __doc__)
    # 1. Read + solve an LP fixture in one call
    m = ssqp.solve_mps(DATA / "simple_lp.mps", device=dev)
    print(f"simple_lp.mps: {m.termination_status()} "
          f"objective={m.objective_value():.6f}")
    print("  x =", np.round(m.values(), 6))

    # 2. A QP with a QMATRIX section goes through the same entry point
    mq = ssqp.solve_mps(DATA / "simple_qp.mps", device=dev)
    print(f"simple_qp.mps: {mq.termination_status()} "
          f"objective={mq.objective_value():.6f}")

    # 3. read_mps returns the Model un-solved: adjust, then optimize
    m2 = ssqp.read_mps(DATA / "bounds_ranges.mps", device=dev)
    m2.optimize()
    print(f"bounds_ranges.mps: {m2.termination_status()} "
          f"objective={m2.objective_value():.6f}")

    # 4. Dual certificates for the constraint rows (beyond the reference)
    duals = mq.duals()
    if duals is not None:
        print("  row duals:", {k: np.round(v, 6) for k, v in duals.items()}
              if isinstance(duals, dict) else np.round(np.asarray(duals), 6))
    return {name: (mm.termination_status(), mm.objective_value())
            for name, mm in (("simple_lp", m), ("simple_qp", mq),
                             ("bounds_ranges", m2))}


if __name__ == "__main__":
    main()
