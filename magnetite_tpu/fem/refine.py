"""Mixed-precision iterative refinement: f64 accuracy at f32 speed.

The reference solves everything in f64 on the host CPU
(/root/reference/src/solver.rs:295-296, DMatrix<f64>). A bandwidth-bound
solve moves half the bytes per iteration in f32, and f32 alone cannot
reach f64-grade residuals. The classical fix is iterative refinement:

    repeat:  r = b - A x          (f64 operator: exact residual)
             d ~= A^-1 r          (f32 PCG + multigrid: all the iterations)
             x = x + d            (f64 accumulation)

Each pass contracts the true f64 residual by roughly the accuracy of the
inner f32 solve (~1e-5 relative), so two or three passes reach 1e-8..1e-12
relative residual while >95% of the work (the inner CG/smoother matvecs)
runs on f32 fields. The f64 matvec runs a handful of times per solve.

Requires jax_enable_x64; `fem/solve.py` engages it automatically when the
requested tolerance is below what f32 can reach ("auto" refine mode).
"""

from __future__ import annotations

from typing import Callable, NamedTuple, Optional

import jax
import jax.numpy as jnp

from .cg import MatVec, pcg


class RefineResult(NamedTuple):
    x: jax.Array  # f64 solution
    outer_steps: jax.Array  # int32: refinement passes taken
    inner_iterations: jax.Array  # int32: total f32 CG iterations
    residual_norm: jax.Array  # final f64 ||b - A x||
    converged: jax.Array  # bool


def mixed_precision_solve(
    op64: MatVec,
    op32: MatVec,
    b: jax.Array,  # f64
    *,
    preconditioner32: Optional[MatVec] = None,
    x0: Optional[jax.Array] = None,  # f64, must satisfy fixed DOFs
    rtol: float = 1e-10,
    atol: float = 0.0,
    # 1e-4 sits safely above the f32 CG stall floor at 1M+ DOF (rounding
    # noise grows ~sqrt(N)*eps); pushing the inner tolerance lower burns
    # iterations fighting f32 noise that the next f64 residual fixes anyway
    inner_rtol: float = 1e-4,
    inner_maxiter: int = 100,
    max_outer: int = 8,
    dot: Callable[[jax.Array, jax.Array], jax.Array] = None,
) -> RefineResult:
    """Solve A x = b (SPD) to f64-grade residual with f32 inner solves.

    op64 must be the same operator as op32 evaluated in f64 (same BC
    reduction). `dot`, when given, is used BOTH for the f64 convergence
    check and inside the inner f32 PCG -- inject a psum dot and the whole
    refinement runs sharded over a device mesh (each chip holding its row
    band; see parallel/stencil_shard.sharded_stencil_refined_solve).
    """
    f64 = b.dtype
    dot64 = dot if dot is not None else (lambda a, c: jnp.sum(a * c))
    x = jnp.zeros_like(b) if x0 is None else x0.astype(f64)

    bnorm = jnp.sqrt(dot64(b, b))
    threshold = jnp.maximum(rtol * bnorm, atol)
    thresh2 = threshold * threshold

    def residual2(x):
        r = b - op64(x)
        return r, dot64(r, r)

    r0, rn0 = residual2(x)

    def cond(state):
        _, _, rnorm2, k, _ = state
        return (rnorm2 > thresh2) & (k < max_outer)

    def body(state):
        x, r, _, k, inner_total = state
        # scale the residual toward unit norm so the f32 inner solve works
        # in a healthy dynamic range regardless of the outer residual size
        scale = jnp.sqrt(dot64(r, r))
        safe = jnp.where(scale > 0, scale, 1.0)
        r32 = (r / safe).astype(jnp.float32)
        inner_kwargs = {"dot": dot} if dot is not None else {}
        inner = pcg(
            op32,
            r32,
            preconditioner=preconditioner32,
            rtol=inner_rtol,
            maxiter=inner_maxiter,
            **inner_kwargs,
        )
        x = x + inner.x.astype(f64) * safe
        r, rnorm2 = residual2(x)
        return x, r, rnorm2, k + 1, inner_total + inner.iterations

    x, r, rnorm2, k, inner_total = jax.lax.while_loop(
        cond, body, (x, r0, rn0, jnp.int32(0), jnp.int32(0))
    )
    rnorm = jnp.sqrt(rnorm2)
    return RefineResult(
        x=x,
        outer_steps=k,
        inner_iterations=inner_total,
        residual_norm=rnorm,
        converged=rnorm2 <= thresh2,
    )
