"""End-to-end FEA pipeline sharded over a device mesh.

The complete reference-equivalent run — solve, force recovery, stress
recovery — on every visible device at once: a plate-with-hole is Delaunay
meshed, node-sharded over a `jax.sharding.Mesh`, solved with halo-exchange
PCG (sharded AMG preconditioner), and the recovered `SolveResult` is
cross-checked against the single-device `solve_system` on the same
problem. Reference bar: kyle-tennison/Magnetite src/main.rs:53-76 +
src/solver.rs:412-535 (one command does everything — here on N devices).

Run (simulating 8 devices on CPU, the same mesh the driver dryrun uses):

    XLA_FLAGS=--xla_force_host_platform_device_count=8 JAX_PLATFORMS=cpu \
        python examples/multichip_pipeline.py

On a multi-GPU host, drop the env vars — every visible GPU joins the
mesh. The CLI equivalent is `magnetite-tpu ... --shard`.
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import time

import numpy as np


def main():
    import jax

    jax.config.update("jax_enable_x64", True)  # 1e-6 parity needs f64

    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import (
        BoundaryRegion,
        BoundaryRule,
        BoundaryTarget,
        ModelMetadata,
        SolverOptions,
    )
    from magnetite_tpu.fem.solve import solve_system
    from magnetite_tpu.meshing.delaunay_backend import triangulate
    from magnetite_tpu.parallel.pipeline import compile_sharded_problem
    from magnetite_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    n_dev = len(jax.devices())
    device_mesh = jax.make_mesh((n_dev,), ("shard",))
    print(f"device mesh: {n_dev} x {jax.devices()[0].platform}")

    # plate with a rectangular hole, pulled 1% on the right edge
    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    mesh = triangulate([outer, hole], 0.0, 0.02)
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
    metadata = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.02)
    opts = SolverOptions(cg_rtol=1e-8)
    print(f"mesh: {mesh.num_nodes} nodes, {len(mesh.tris)} elements")

    t0 = time.perf_counter()
    problem = compile_sharded_problem(
        mesh, bca, metadata, opts, device_mesh=device_mesh
    )
    t1 = time.perf_counter()
    result = problem.solve()
    t2 = time.perf_counter()
    print(
        f"sharded pipeline: prep {t1 - t0:.2f} s, solve+recovery "
        f"{t2 - t1:.2f} s, {result.iterations} iterations, "
        f"relative residual {result.residual_rel:.2e}"
    )

    # parity vs the single-device pipeline
    single = solve_system(mesh, bca, metadata, opts)
    for field in ("u", "f", "sigma", "stress", "von_mises"):
        a = np.asarray(getattr(result, field))
        b = np.asarray(getattr(single, field))
        scale = max(float(np.abs(b).max()), 1e-30)
        err = float(np.abs(a - b).max()) / scale
        status = "ok" if err < 1e-6 else "DIVERGED"
        print(f"  {field:>10}: max relative diff {err:.2e}  {status}")
        assert err < 1e-6, field

    vm = np.asarray(result.von_mises)
    print(f"peak von Mises: {vm.max():.3e} Pa (hole corners)")


if __name__ == "__main__":
    main()
