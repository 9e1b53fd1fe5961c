"""1M-element plate-with-hole: assemble + solve to 1e-8 relative residual.

The scale showcase: a structured 512x1024-cell annulus grid (1,048,576 CST
elements), solved with the stencil operator + geometric multigrid + f64/f32
mixed-precision refinement. It runs identically on the GPU and the CPU
(slower). Run:

    python examples/plate_benchmark.py [n_radial n_tangential]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import time

import jax

jax.config.update("jax_enable_x64", True)  # enables mixed-precision refinement

import numpy as np

from magnetite_tpu.bc import BCArrays
from magnetite_tpu.config import ModelMetadata, SolverOptions
from magnetite_tpu.fem.solve import compile_problem
from magnetite_tpu.meshing.generators import plate_with_hole_mesh


def main():
    import jax

    from magnetite_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    nr = int(sys.argv[1]) if len(sys.argv) > 1 else 512
    nt = int(sys.argv[2]) if len(sys.argv) > 2 else 1024

    t0 = time.perf_counter()
    mesh = plate_with_hole_mesh(nr, nt)
    print(f"mesh: {mesh.num_elements} elements, {mesh.num_nodes} nodes "
          f"({time.perf_counter() - t0:.2f}s)")

    # clamp the left edge, pull the right edge 0.01 in +x
    c = mesh.coords
    n = mesh.num_nodes
    u_known = np.zeros((n, 2), dtype=bool)
    u_value = np.zeros((n, 2))
    u_known[np.isclose(c[:, 0], c[:, 0].min())] = True
    right = np.isclose(c[:, 0], c[:, 0].max())
    u_known[right, 0] = True
    u_value[right, 0] = 0.01
    bca = BCArrays(u_known=u_known, u_value=u_value, f_value=np.zeros((n, 2)))

    metadata = ModelMetadata(
        youngs_modulus=69e9, poisson_ratio=0.33, part_thickness=0.5,
        characteristic_length_min=0.0, characteristic_length_max=0.01,
    )
    t0 = time.perf_counter()
    problem = compile_problem(
        mesh, bca, metadata, SolverOptions(dtype="float32", cg_rtol=1e-8)
    )
    print(f"prep: {time.perf_counter() - t0:.2f}s "
          f"(operator={problem.mode}, preconditioner={problem.preconditioner}, "
          f"refine={problem.refine})")

    t0 = time.perf_counter()
    result = problem.solve()  # includes first-call jit compile
    print(f"first solve (incl. compile): {time.perf_counter() - t0:.1f}s")

    t0 = time.perf_counter()
    result = problem.solve()
    print(f"solve: {time.perf_counter() - t0:.3f}s, "
          f"{result.iterations} inner iterations, "
          f"relative residual {result.residual_rel:.2e}")
    print(f"max |u| = {np.abs(result.u).max():.4e}, "
          f"max von Mises = {result.von_mises.max():.4e}")


if __name__ == "__main__":
    main()
