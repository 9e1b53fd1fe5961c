"""Per-iteration cost split of the unstructured (DIA + AMG) refined solve.

The flagship 1M-element delaunay solve runs f64 PCG whose preconditioner
is the f32 AMG V-cycle (fem/solve._run_linear_solve). This probe rebuilds
the exact operator/preconditioner closures `_solve_dia` wires up -- from a
real `compile_problem` result, so bands/hierarchy/constraints are the
production ones -- and chain-times each piece with the same
dispatch-canceling scan-slope method as bench.py's SpMV roofline (a
per-call dispatch would otherwise swamp sub-millisecond operators).

Reports ms per apply for: the f64 band matvec, the f32 band matvec, the
f32 block-Jacobi apply, the full f32 V(3,3) cycle, the f64-boundary
preconditioner wrapper, and an f64 CG vector step (dot + axpy), plus the
solved-for iteration count and the measured solve time they should add to.

Usage:  python scripts/profile_unstructured.py [--h 0.00258] [--json]
"""

from __future__ import annotations

import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _chain_ms(make_fn, aux, x0, lengths=(8, 32), reps=3):
    """Slope of scan-chained applies: ms per apply, dispatch canceled.

    `aux` (a pytree of device arrays) is passed as a jit ARGUMENT --
    closing over multi-hundred-MB operands would embed them as HLO
    constants in the compiled program."""
    import jax
    import jax.numpy as jnp

    def make(length):
        @jax.jit
        def f(aux, u):
            fn = make_fn(aux)

            def step(v, _):
                w = fn(v)
                # keep magnitudes finite across long chains
                nrm = jnp.sqrt(jnp.sum(w * w))
                return w / jnp.where(nrm == 0, 1.0, nrm), None

            v, _ = jax.lax.scan(step, u, None, length=length)
            return jnp.sum(v)

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
    from magnetite_tpu.fem.amg import amg_sweep_schedule, make_amg_preconditioner
    from magnetite_tpu.fem.dia import (
        block_jacobi_inverse_t,
        dia_diag_blocks,
        make_dia_operator,
    )
    from magnetite_tpu.fem.solve import compile_problem
    from magnetite_tpu.meshing.delaunay_backend import triangulate

    argv = sys.argv[1:]
    h = float(argv[argv.index("--h") + 1]) if "--h" in argv else 0.00258

    # the bench's 1M-element plate-with-hole (bench.py:_phase_unstructured)
    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    t0 = time.perf_counter()
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
    bca = apply_boundary_conditions(mesh.coords, rules)
    metadata = ModelMetadata(69e9, 0.33, 0.5, 0.0, h)
    print(
        f"mesh: {mesh.num_elements} elements / {mesh.num_nodes} nodes "
        f"({time.perf_counter() - t0:.1f} s)",
        file=sys.stderr,
    )

    t0 = time.perf_counter()
    problem = compile_problem(
        mesh,
        bca,
        metadata,
        SolverOptions(
            dtype="float32", cg_rtol=1e-8, refine="on", keep_operator_host=True
        ),
    )
    print(f"prep: {time.perf_counter() - t0:.1f} s", file=sys.stderr)
    if problem.mode != "dia" or problem.preconditioner != "amg":
        raise SystemExit(
            f"expected dia+amg, got {problem.mode}+{problem.preconditioner}"
        )

    # production device arrays straight out of the compiled problem
    (bands64,) = problem.args[-1]
    amg_args = problem.args[10]
    offsets = problem.operator_host.offsets
    u_known = np.asarray(problem.args[4])  # renumbered order
    free64 = jnp.asarray((~u_known).astype(np.float64).T)
    free32 = free64.astype(jnp.float32)
    bands32 = bands64.astype(jnp.float32)

    def make_op(aux):
        bands_, free_ = aux
        matvec = make_dia_operator(bands_, offsets)

        def op(v):
            return free_ * matvec(free_ * v) + (1.0 - free_) * v

        return op

    def make_jac(aux):
        bands_, free_ = aux
        return block_jacobi_inverse_t(
            dia_diag_blocks(bands_, offsets), free_
        )

    s = amg_sweep_schedule(True)

    def make_vcycle(aux):
        amg_, bands_, free_ = aux
        matvec = make_dia_operator(bands_, offsets)
        return make_amg_preconditioner(
            amg_,
            make_op((bands_, free_)),
            make_jac((bands_, free_)),
            layout="t",
            pre_sweeps=s,
            post_sweeps=s,
            a_op=lambda v: free_ * matvec(free_ * v),
        )

    def make_precond64(aux):  # the boundary wrapper from _run_linear_solve
        vcycle32 = make_vcycle(aux)

        def precond64(r):
            nrm = jnp.sqrt(jnp.sum(r * r))
            safe = jnp.where(nrm == 0, 1.0, nrm)
            return (
                vcycle32((r / safe).astype(jnp.float32)).astype(r.dtype)
                * safe
            )

        return precond64

    def make_cgvec(aux):  # one dot + one axpy, the CG bookkeeping unit
        def cgvec64(v):
            a = jnp.sum(v * v)
            return v + v / jnp.where(a == 0, 1.0, a)

        return cgvec64

    # V-cycle internals: level-0 transfer pair and the coarse-only cycle
    from magnetite_tpu.fem.amg import _block_ell_matvec, make_coarse_cycle

    transfers, coarse, ci = amg_args[:3]
    fast0 = amg_args[3] if len(amg_args) > 3 else ()
    n1 = coarse[0][2].shape[0]  # level-1 node count

    def make_transfer_pair(aux):
        if fast0:
            # factored P/P^T composition (the shipped path): coarse ->
            # fine (P = (I - wDinvA) P0) -> coarse (P^T), chainable
            agg, p0, pt0_cols, pt0_vals, dinv0w = aux[0]
            a_bands, a_free = aux[1]
            mv = make_dia_operator(a_bands, offsets)

            def a_op(v):
                return a_free * mv(a_free * v)

            def dinv(v):
                return jnp.einsum(
                    "nij,jn->in", dinv0w, v, precision="highest"
                )

            def pair(xc):
                uf = jnp.einsum(
                    "nij,nj->ni", p0, xc[agg], precision="highest"
                ).T
                xf = uf - dinv(a_op(uf))
                tmp = xf - a_op(dinv(xf))
                return jnp.einsum(
                    "nwij,jnw->ni", pt0_vals, tmp[:, pt0_cols],
                    precision="highest",
                )

            return pair

        p_cols, p_vals, pt_cols, pt_vals = aux

        def pair(xc):  # coarse -> fine (P) -> coarse (P^T), chainable
            xf = _block_ell_matvec(p_cols, p_vals, xc)
            return _block_ell_matvec(pt_cols, pt_vals, xf)

        return pair

    def make_coarse_only(aux):
        # mirror make_amg_preconditioner exactly: V(1,1) below the fine
        # level, banded coarse operators when present
        transfers_, coarse_, ci_ = aux[:3]
        cyc = make_coarse_cycle(
            transfers_[1:],
            coarse_,
            ci_,
            pre_sweeps=1,
            post_sweeps=1,
            coarse_bands=aux[4] if len(aux) > 4 else (),
        )
        return lambda rc: cyc(0, rc)

    n = mesh.num_nodes
    rng = np.random.default_rng(0)
    x64 = jnp.asarray(rng.standard_normal((2, n)))
    x32 = x64.astype(jnp.float32)
    xc32 = jnp.asarray(
        rng.standard_normal((n1, 3)), dtype=jnp.float32
    )

    d = len(offsets)
    mv_bytes = {  # bands + read u + write y
        "op64_ms": (d * 4 * n + 4 * n) * 8,
        "op32_ms": (d * 4 * n + 4 * n) * 4,
    }
    out = {"elements": mesh.num_elements, "nodes": n, "n_bands": d}
    out["transfer_shapes"] = [list(t[0].shape) for t in transfers]
    out["coarse_shapes"] = [list(c[0].shape) for c in coarse]
    for name, make_fn, aux, x in (
        ("op64_ms", make_op, (bands64, free64), x64),
        ("op32_ms", make_op, (bands32, free32), x32),
        ("jac32_ms", make_jac, (bands32, free32), x32),
        ("vcycle32_ms", make_vcycle, (amg_args, bands32, free32), x32),
        ("precond64_ms", make_precond64, (amg_args, bands32, free32), x64),
        ("cgvec64_ms", make_cgvec, (), x64),
        (
            "transfer0_pair_ms",
            make_transfer_pair,
            (fast0, (bands32, free32)) if fast0 else transfers[0],
            xc32,
        ),
        ("coarse_cycle_ms", make_coarse_only, amg_args, xc32),
    ):
        ms = _chain_ms(make_fn, aux, x)
        out[name] = round(ms, 3)
        if name in mv_bytes:
            out[name.replace("_ms", "_gbps")] = round(
                mv_bytes[name] / (ms / 1e3) / 1e9, 1
            )
        print(f"{name}: {out[name]}", file=sys.stderr)

    t0 = time.perf_counter()
    outs = jax.block_until_ready(problem.solve_device())
    out["solve_s"] = round(time.perf_counter() - t0, 3)
    out["cg_iters"] = int(np.asarray(outs[5]))
    out["per_iter_ms"] = round(out["solve_s"] / max(out["cg_iters"], 1) * 1e3, 1)
    out["accounted_ms"] = round(
        out["op64_ms"] + out["precond64_ms"] + 3 * out["cgvec64_ms"], 1
    )
    print(json.dumps(out))


if __name__ == "__main__":
    main()
