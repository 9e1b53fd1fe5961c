"""Arbitrary-geometry plate at scale: Delaunay mesh + AMG to 1e-8 relative.

The reference's core use case (any SVG/CSV geometry -> mesh -> solve,
src/mesher.rs:939-974) pushed to 1M elements: the built-in Delaunay mesher
triangulates a plate-with-hole, the solver auto-selects the banded DIA
operator, and smoothed-aggregation AMG (fem/amg.py) holds CG at ~15
iterations regardless of mesh size. With --precision mixed semantics
(refine="on"), f64 CG runs with the f32 V-cycle preconditioner for
1e-8-grade residuals at f32 V-cycle cost. Run:

    python examples/unstructured_plate.py [h]

h is the characteristic mesh length (default 0.00258 -> ~1M elements;
try 0.01 for a quick ~66k-element run).
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import time

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

    h = float(sys.argv[1]) if len(sys.argv) > 1 else 0.00258

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    t0 = time.perf_counter()
    mesh = triangulate([outer, hole], 0.0, h)
    print(
        f"meshed {mesh.num_nodes:,} nodes / {mesh.num_elements:,} elements "
        f"in {time.perf_counter() - t0:.1f}s"
    )

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
    bca = apply_boundary_conditions(mesh.coords, rules)
    metadata = ModelMetadata(69e9, 0.33, 0.5, 0.0, h)

    t0 = time.perf_counter()
    problem = compile_problem(
        mesh,
        bca,
        metadata,
        SolverOptions(
            dtype="float32",
            cg_rtol=1e-8,
            refine="on",
            # force AMG even below the auto threshold so small demo runs
            # (h=0.01+) still show the mesh-independent convergence
            preconditioner="amg",
        ),
    )
    print(
        f"prepared in {time.perf_counter() - t0:.1f}s "
        f"(operator={problem.mode}, preconditioner={problem.preconditioner}, "
        f"amg levels={problem.timings.get('amg_levels')})"
    )

    result = problem.solve()  # first call compiles
    t0 = time.perf_counter()
    result = problem.solve()
    wall = time.perf_counter() - t0
    print(
        f"warm solve: {wall:.3f}s, {result.iterations} CG iterations, "
        f"relative residual {result.residual_rel:.2e}"
    )
    print(
        f"max |u| = {np.abs(result.u).max():.4e}, "
        f"max von Mises = {result.von_mises.max():.4e}"
    )


if __name__ == "__main__":
    main()
