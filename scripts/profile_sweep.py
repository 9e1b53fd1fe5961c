"""Per-component timing of the unstructured lane sweeps (bench.py's
bench_unstructured_sweep / bench_unstructured_material_sweep configs).

Splits the warm solve into host I/O (perm + upload + fetch) vs device
compute, and extracts the per-CG-iteration cost by timing the jitted core
at two iteration counts -- so throughput work targets
the measured bottleneck instead of a guess.

Usage: python scripts/profile_sweep.py [--h 0.03] [--lanes 4096]
       [--iters 25] [--material]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def jtree_block(out):
    """Force execution by FETCHING the smallest leaf: a device->host read
    ends only after every computation it depends on."""
    import jax

    leaves = jax.tree_util.tree_leaves(out)
    small = min(
        (l for l in leaves if hasattr(l, "block_until_ready")),
        key=lambda l: getattr(l, "size", 1 << 60),
        default=None,
    )
    if small is not None:
        np.asarray(jax.device_get(small))


def timeit(fn, repeats=3):
    jtree_block(fn())  # compile + warm
    best = float("inf")
    for _ in range(repeats):
        t0 = time.perf_counter()
        jtree_block(fn())
        best = min(best, time.perf_counter() - t0)
    return best


def main():
    import jax
    import jax.numpy as jnp

    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import (
        BoundaryRegion,
        BoundaryRule,
        BoundaryTarget,
        ModelMetadata,
    )
    from magnetite_tpu.meshing.delaunay_backend import triangulate
    from magnetite_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    argv = sys.argv[1:]

    def arg(flag, default, cast=float):
        return cast(argv[argv.index(flag) + 1]) if flag in argv else default

    h = arg("--h", 0.03)
    b = arg("--lanes", 4096, int)
    iters = arg("--iters", 25, int)
    material = "--material" in argv

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    mesh = triangulate([outer, hole], 0.0, h)
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
    base = apply_boundary_conditions(mesh.coords, rules)
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, h)
    print(
        f"mesh: {mesh.num_elements} elements / {mesh.num_nodes} nodes, "
        f"{b} lanes, {iters} iters, material={material}",
        file=sys.stderr,
    )
    out = {"nodes": mesh.num_nodes, "lanes": b, "iters": iters}

    right = mesh.coords[:, 0] > 3.0 - 1e-6
    rng = np.random.default_rng(0)
    pulls = rng.uniform(0.005, 0.02, b).astype(np.float32)
    u_values = np.tile(base.u_value[None], (b, 1, 1)).astype(np.float32)
    u_values[:, right, 0] = pulls[:, None]
    f_values = np.zeros((b, mesh.num_nodes, 2), dtype=np.float32)

    if material:
        from magnetite_tpu.parallel.sweep import (
            _material_dia_amg_lanes_jit,
            compile_unstructured_material_sweep,
        )

        e_mods = rng.uniform(40e9, 250e9, b).astype(np.float32)
        nus = rng.uniform(0.22, 0.38, b).astype(np.float32)
        ts = rng.uniform(0.2, 1.0, b).astype(np.float32)
        extra = (e_mods, nus, ts)

        def compile_fn(its):
            return compile_unstructured_material_sweep(
                mesh, base, iterations=its, refined=False
            )

        def core_fn(c, up, fp, ex):
            return _material_dia_amg_lanes_jit(
                c.bands3, c.bands3_sm, c.offsets, c.mamg, c.b_mat, c.free,
                up, fp, *ex, c.tris, c.iterations, c.amg_sweeps,
            )
    else:
        from magnetite_tpu.parallel.sweep import (
            _dia_amg_lanes_jit,
            compile_unstructured_sweep,
        )

        extra = (rng.uniform(0.5, 2.0, b),)

        def compile_fn(its):
            return compile_unstructured_sweep(
                mesh, base, md, iterations=its, refined=False
            )

        def core_fn(c, up, fp, ex):
            return _dia_amg_lanes_jit(
                c.bands, c.bands_sm, c.offsets, c.amg, c.d_mat, c.b_mat,
                c.free, up, fp, *ex, c.tris, c.iterations, c.amg_sweeps,
            )

    t0 = time.perf_counter()
    compiled = compile_fn(iters)
    out["compile_setup_s"] = round(time.perf_counter() - t0, 2)

    t0 = time.perf_counter()
    jtree_block(compiled.solve(u_values, f_values, *extra))
    out["first_solve_s"] = round(time.perf_counter() - t0, 2)

    t = timeit(lambda: compiled.solve(u_values, f_values, *extra))
    out["solve_warm_s"] = round(t, 3)
    out["solves_per_s"] = round(b / t)

    # device-resident operands: isolates the jitted core from host
    # perm/upload/fetch
    perm = compiled.perm
    uvp = u_values[:, perm, :] if perm is not None else u_values
    fvp = f_values[:, perm, :] if perm is not None else f_values
    up = jnp.asarray(uvp, dtype=compiled.dtype)
    fp = jnp.asarray(fvp, dtype=compiled.dtype)
    ex = tuple(jnp.asarray(e, dtype=compiled.dtype) for e in extra)
    jax.block_until_ready((up, fp, ex))

    t_core = timeit(lambda: core_fn(compiled, up, fp, ex))
    out["core_warm_s"] = round(t_core, 3)
    out["host_io_s"] = round(t - t_core, 3)

    # per-iteration slope from a 1-iteration compile
    compiled1 = compile_fn(1)
    t_core1 = timeit(lambda: core_fn(compiled1, up, fp, ex))
    out["core_1iter_s"] = round(t_core1, 3)
    per_iter = (t_core - t_core1) / (iters - 1)
    out["per_iter_ms"] = round(per_iter * 1e3, 3)
    out["fixed_ms"] = round((t_core1 - per_iter) * 1e3, 3)
    print(json.dumps(out))


if __name__ == "__main__":
    main()
