"""Slope-method component timing of the unstructured lane-sweep V-cycle.

Each component is timed as a lax.scan chain of two lengths with a scalar
fetch (the dispatch-canceling method from profile_unstructured.py), so
per-call dispatch and sync costs cancel out.

Usage: python scripts/profile_sweep_parts.py [--h 0.03] [--lanes 4096]
"""

import json
import os
import sys
import time

import numpy as np

sys.path.insert(
    0, os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
)


def slope_ms(make_fn, aux, x0, lengths=(1, 5), reps=2):
    import jax
    import jax.numpy as jnp

    def make(length):
        @jax.jit
        def f(aux, u):
            fn = make_fn(aux)

            def step(v, _):
                w = fn(v)
                nrm = jnp.sqrt(
                    sum(jnp.sum(l * l) for l in jax.tree_util.tree_leaves(w))
                )
                scale = 1.0 / jnp.where(nrm == 0, 1.0, nrm)
                return jax.tree_util.tree_map(lambda l: l * scale, w), None

            v, _ = jax.lax.scan(step, u, None, length=length)
            return sum(jnp.sum(l) for l in jax.tree_util.tree_leaves(v))

        return f

    times = []
    for length in lengths:
        f = make(length)
        float(f(aux, x0))  # compile + warm
        ts = []
        for _ in range(reps):
            t0 = time.perf_counter()
            float(f(aux, x0))
            ts.append(time.perf_counter() - t0)
        times.append(min(ts))
    return (times[1] - times[0]) / (lengths[1] - lengths[0]) * 1e3


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
    from magnetite_tpu.parallel.sweep import (
        _lane_dot,
        compile_unstructured_sweep,
    )
    from magnetite_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()

    argv = sys.argv[1:]

    def arg(flag, default, cast=float):
        return cast(argv[argv.index(flag) + 1]) if flag in argv else default

    h = arg("--h", 0.03)
    b = arg("--lanes", 4096, int)

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
    compiled = compile_unstructured_sweep(
        mesh, base, md, iterations=25, refined=False
    )
    n = compiled.n_nodes
    print(f"mesh: {n} nodes, {b} lanes", file=sys.stderr)
    out = {"nodes": n, "lanes": b, "n_bands": len(compiled.offsets)}

    rng = np.random.default_rng(0)
    u = jnp.asarray(
        rng.standard_normal((2, n, b)), dtype=jnp.float32
    )
    offsets = compiled.offsets
    free_sm = compiled.free.astype(jnp.float32)[:, :, None]

    def make_band_mv(aux):
        bands_sm = aux

        def mv(uu):
            y0 = jnp.zeros_like(uu[0])
            y1 = jnp.zeros_like(uu[1])
            for d_idx, off in enumerate(offsets):
                shifted = jnp.roll(uu, -off, axis=1) if off != 0 else uu
                bb = bands_sm[d_idx][:, :, :, None]
                y0 = y0 + bb[0, 0] * shifted[0] + bb[0, 1] * shifted[1]
                y1 = y1 + bb[1, 0] * shifted[0] + bb[1, 1] * shifted[1]
            return jnp.stack([y0, y1])

        return mv

    t = slope_ms(make_band_mv, compiled.bands_sm, u)
    out["lane_matvec_ms"] = round(t, 3)
    nbytes = u.nbytes * 2 + compiled.bands_sm.nbytes
    out["lane_matvec_gbps"] = round(nbytes / t / 1e6, 1)

    from magnetite_tpu.fem.amg import (
        amg_sweep_schedule,
        make_amg_preconditioner,
        make_coarse_cycle,
    )
    from magnetite_tpu.parallel.blocks import (
        guarded_inv2,
        reduce_diag_blocks,
    )

    zero_idx = offsets.index(0)

    def make_vcycle(aux):
        bands_sm, amg = aux
        mv = make_band_mv(bands_sm)

        def op_sm(v):
            return free_sm * mv(free_sm * v) + (1.0 - free_sm) * v

        d = reduce_diag_blocks(bands_sm[zero_idx], free_sm[:, :, 0])
        inv_b = guarded_inv2(d)[:, :, :, None]

        def jac0(r):
            p0 = inv_b[0, 0] * r[0] + inv_b[0, 1] * r[1]
            p1 = inv_b[1, 0] * r[0] + inv_b[1, 1] * r[1]
            return jnp.stack([p0, p1])

        s = amg_sweep_schedule(False, 0)
        return make_amg_preconditioner(
            amg, op_sm, jac0, layout="tl", pre_sweeps=s, post_sweeps=s,
            a_op=lambda v: free_sm * mv(free_sm * v),
        )

    t = slope_ms(make_vcycle, (compiled.bands_sm, compiled.amg), u)
    out["lane_vcycle_ms"] = round(t, 3)

    def make_jac(aux):
        bands_sm = aux
        d = reduce_diag_blocks(bands_sm[zero_idx], free_sm[:, :, 0])
        inv_b = guarded_inv2(d)[:, :, :, None]

        def jac0(r):
            p0 = inv_b[0, 0] * r[0] + inv_b[0, 1] * r[1]
            p1 = inv_b[1, 0] * r[0] + inv_b[1, 1] * r[1]
            return jnp.stack([p0, p1])

        return jac0

    out["lane_jac_ms"] = round(slope_ms(make_jac, compiled.bands_sm, u), 3)

    def make_dot(aux):
        del aux

        def f(v):
            s = _lane_dot(v, v)  # [B]
            return v * (1.0 + 0.0 * s[None, None, :])

        return f

    out["lane_dot_ms"] = round(slope_ms(make_dot, None, u), 3)

    # level-0 transfer pair (gather form) + coarse cycle, via the amg tuple
    amg = compiled.amg
    transfers, coarse, ci, fast0 = amg[0], amg[1], amg[2], amg[3]
    agg, p0, pt0_cols, pt0_vals, dinv0w = fast0
    n1 = coarse[0][2].shape[0]
    hp = {"precision": "highest"}

    def make_transfer0(aux):
        bands_sm = aux
        mv = make_band_mv(bands_sm)

        def a_op(v):
            return free_sm * mv(free_sm * v)

        def dinv_apply(v):
            return jnp.einsum("nij,jnb->inb", dinv0w, v, **hp)

        def pair(res):
            tmp = res - a_op(dinv_apply(res))
            rc = jnp.einsum("nwij,jnwb->nib", pt0_vals, tmp[:, pt0_cols], **hp)
            uf = jnp.einsum("nij,njb->nib", p0, rc[agg], **hp).transpose(
                1, 0, 2
            )
            return uf - dinv_apply(a_op(uf))

        return pair

    out["lane_transfer0_ms"] = round(
        slope_ms(make_transfer0, compiled.bands_sm, u), 3
    )

    def make_coarse(aux):
        transfers_, coarse_, ci_ = aux
        cycle = make_coarse_cycle(
            transfers_[1:], coarse_, ci_, pre_sweeps=1, post_sweeps=1
        )

        def f(rc):
            return cycle(0, rc)

        return f

    rc0 = jnp.asarray(
        rng.standard_normal((n1, 3, b)), dtype=jnp.float32
    )
    out["lane_coarse_ms"] = round(
        slope_ms(make_coarse, (transfers, coarse, ci), rc0), 3
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
