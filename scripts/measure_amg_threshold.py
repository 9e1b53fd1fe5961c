"""Measure AMG-vs-block-Jacobi crossover on small/mid unstructured meshes.

`SolverOptions.amg_auto_min_nodes` (config.py) was a
guess (20k). This script produces the data to set it: for a ladder of
delaunay mesh sizes it records the AMG hierarchy build time (one-time
host cost, persisted with checkpoints), warm solve time + iteration count
under both preconditioners, and prints one JSON line per size.

Run on the GPU, nothing else running:

    python scripts/measure_amg_threshold.py            # GPU
    JAX_PLATFORMS=cpu python scripts/measure_amg_threshold.py  # CPU sanity
"""

import json
import sys
import time

sys.path.insert(0, ".")

import numpy as np


def main():
    import jax

    jax.config.update("jax_enable_x64", True)
    from magnetite_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import (
        BoundaryRegion,
        BoundaryRule,
        BoundaryTarget,
        ModelMetadata,
        SolverOptions,
    )
    from magnetite_tpu.fem.solve import compile_problem
    from magnetite_tpu.meshing.delaunay_backend import triangulate

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    rules = (
        BoundaryRule(
            "left", BoundaryRegion(x_max=1e-6), BoundaryTarget(ux=0.0, uy=0.0)
        ),
        BoundaryRule(
            "right",
            BoundaryRegion(x_min=3.0 - 1e-6),
            BoundaryTarget(ux=0.01, fy=0.0),
        ),
    )

    for h in (0.045, 0.032, 0.026, 0.02, 0.016, 0.013, 0.011):
        mesh = triangulate([outer, hole], 0.0, h)
        bca = apply_boundary_conditions(mesh.coords, rules)
        md = ModelMetadata(69e9, 0.33, 0.5, 0.0, h)
        row = {"h": h, "nodes": mesh.num_nodes, "elements": mesh.num_elements}
        for precond in ("block_jacobi", "amg"):
            opts = SolverOptions(
                dtype="float32",
                cg_rtol=1e-8,
                refine="on",
                preconditioner=precond,
                amg_auto_min_nodes=0,
                max_cg_iters=40_000,
            )
            try:
                t0 = time.perf_counter()
                problem = compile_problem(mesh, bca, md, opts)
                row[f"{precond}_compile_s"] = round(
                    time.perf_counter() - t0, 3
                )
                if precond == "amg" and problem.amg_setup is not None:
                    row["amg_levels"] = problem.amg_setup.level_sizes
                # warm solve (second call reuses the jitted core)
                problem.solve()
                t0 = time.perf_counter()
                res = problem.solve()
                row[f"{precond}_solve_s"] = round(
                    time.perf_counter() - t0, 4
                )
                row[f"{precond}_iters"] = int(res.iterations)
                row[f"{precond}_rel"] = float(res.residual_rel)
            except Exception as err:  # record, keep the ladder going
                row[f"{precond}_error"] = f"{type(err).__name__}: {err}"
        print(json.dumps(row), flush=True)


if __name__ == "__main__":
    main()
