"""End-to-end device solve: stiffness -> assembly -> PCG -> recovery.

Host/device split (the device layering of reference src/solver.rs:543-586):
  host:   operator-format selection + (for irregular meshes) sparsity
          structure build; structured-grid meshes build their scatter
          pattern ON DEVICE from connectivity (assemble_stencil_fused
          computes pair slots inline from the resident tris array)
  device: ONE jitted function doing batched element stiffness (einsum),
          segment_sum assembly, preconditioned CG (optionally f64/f32
          mixed-precision iterative refinement), force + stress recovery.

The jitted core is cached per CoreSpec (solver options + operator format)
so repeated solves -- parameter sweeps, CLI reruns -- pay compilation once.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from functools import lru_cache
from typing import NamedTuple, Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from ..bc import BCArrays
from ..config import ModelMetadata, SolverOptions
from ..errors import InputError, SolverError
from ..meshing.core import Mesh
from .assembly import (
    assemble_dense,
    build_ell_structure,
    extract_block_diagonal,
    EllStructure,
)
from .cg import pcg
from .element import element_stiffness_matrices
from .operator import (
    block_jacobi_preconditioner,
    identity_preconditioner,
    jacobi_preconditioner,
    make_constrained_operator,
    make_ell_operator,
    reduced_rhs,
)
from .stress import element_stress_tensors, scalar_stress, von_mises_stress


@dataclass
class SolveResult:
    u: np.ndarray  # [N,2] nodal displacements
    f: np.ndarray  # [N,2] nodal forces (recovered where unknown)
    sigma: np.ndarray  # [E,3] stress tensors [sx, sy, txy]
    stress: np.ndarray  # [E] reference-formula scalar stress
    von_mises: np.ndarray  # [E] true von Mises stress
    iterations: int
    residual_norm: float  # absolute ||b - K u|| on the reduced system
    residual_rel: float  # residual_norm / ||b||
    converged: bool
    timings: dict
    # ||r|| per iteration for the first SolverOptions.residual_history
    # iterations (empty unless requested; empty in refine mode)
    residual_history: np.ndarray = None


def default_dtype(options: SolverOptions) -> np.dtype:
    if options.dtype is not None:
        return np.dtype(options.dtype)
    return np.dtype(np.float64) if jax.config.jax_enable_x64 else np.dtype(np.float32)


def _make_preconditioner(kind: str, diag_blocks, free_mask):
    if kind == "block_jacobi":
        return block_jacobi_preconditioner(diag_blocks, free_mask)
    if kind == "jacobi":
        return jacobi_preconditioner(diag_blocks, free_mask)
    if kind == "none":
        return identity_preconditioner()
    raise SolverError(f"unknown preconditioner '{kind}'")


# --------------------- operator-format static params -----------------------


class StencilParams(NamedTuple):
    """Structured-grid stencil operator (fem/stencil.py)."""

    rows: int
    cols: int
    wrap: bool
    # canonical generator grid: use scatter-free structured assembly
    canonical: bool = False


class DiaParams(NamedTuple):
    """Diagonal-band operator (fem/dia.py)."""

    offsets: tuple


class HybridParams(NamedTuple):
    """Bands + COO remainder; remainder indices ride in the runtime `cols`
    array as rows/cols pairs (fem/dia.py HybridStructure)."""

    offsets: tuple


class CoreSpec(NamedTuple):
    """Everything that selects one compiled solver core (hashable)."""

    mode: str  # "dense" | "ell" | "dia" | "hybrid" | "stencil"
    params: Union[StencilParams, DiaParams, HybridParams, None]
    preconditioner: str
    rtol: float
    atol: float
    maxiter: int
    stress_sign_threshold: float
    refine: bool = False  # f64/f32 mixed-precision refinement (stencil)
    refine_inner_iters: int = 200
    refine_max_outer: int = 8
    history: int = 0  # record ||r|| for the first N CG iterations
    progress_every: int = 0  # stream a log line every N CG iterations
    amg_sweeps: int = 0  # V-cycle pre/post sweeps; 0 = auto (see config.py)


# ----------------------------- mode cores ----------------------------------


def _observe_kwargs(spec: "CoreSpec") -> dict:
    return dict(history=spec.history, progress_every=spec.progress_every)


def _amg_sweep_kwargs(spec: "CoreSpec") -> dict:
    """Effective V-cycle smoothing schedule (SolverOptions.amg_sweeps).

    spec.refine <=> mixed precision here: refined compiles always upload
    f64 problem arrays (f64 CG) while the V-cycle hierarchy stays f32
    (see compile_problem's upload_dtype / amg_dtype)."""
    from .amg import amg_sweep_schedule

    s = amg_sweep_schedule(spec.refine, spec.amg_sweeps)
    return dict(pre_sweeps=s, post_sweeps=s)


def _grid(a, rows, cols):
    """[N,2] nodal field -> [2, rows, cols] grid field (cols minormost)."""
    return a.T.reshape(2, rows, cols)


def _ungrid(g):
    return g.reshape(2, -1).T


def _reduce_stencil(raw, free_g, wrap):
    """Fold the BC mask reduction into the stencil: identity on fixed DOFs."""
    from .stencil import CENTER, OFFSETS, shift2d

    one = jnp.asarray(1.0, dtype=raw.dtype)
    reduced = []
    for s, (dr, dt) in enumerate(OFFSETS):
        fin = shift2d(free_g, dr, dt, wrap)
        blk = raw[s] * free_g[:, None] * fin[None, :]
        if s == CENTER:
            blk = blk.at[0, 0].add(one - free_g[0])
            blk = blk.at[1, 1].add(one - free_g[1])
        reduced.append(blk)
    return jnp.stack(reduced)


def _stencil_preconditioner(spec: CoreSpec, reduced, free_g, wrap):
    from .multigrid import build_hierarchy, vcycle_preconditioner
    from .stencil import CENTER

    if spec.preconditioner == "multigrid":
        levels = build_hierarchy(reduced, free_g, wrap)
        return vcycle_preconditioner(levels, wrap)
    if spec.preconditioner == "none":
        return identity_preconditioner()
    # block-Jacobi: invert the reduced center blocks
    d = reduced[CENTER]
    a_, b_ = d[0, 0], d[0, 1]
    c_, e_ = d[1, 0], d[1, 1]
    det = a_ * e_ - b_ * c_
    det = jnp.where(det == 0, 1.0, det)
    inv = jnp.stack([jnp.stack([e_, -b_]), jnp.stack([-c_, a_])]) / det

    def precond(r):
        return jnp.einsum("ijrc,jrc->irc", inv, r, precision="highest")

    return precond


def _solve_stencil(spec: CoreSpec, coords, tris, u_known, u_value, f_value, e, nu, t):
    from .stencil import (
        assemble_stencil_fused,
        assemble_stencil_structured,
        make_stencil_operator,
    )

    rows, cols_n, wrap, canonical = spec.params
    free = (~u_known).astype(coords.dtype)
    free_g = _grid(free, rows, cols_n)
    u_fixed_g = _grid(u_value, rows, cols_n)
    f_g = _grid(f_value, rows, cols_n)

    if canonical:
        raw = assemble_stencil_structured(coords, e, nu, t, rows, cols_n, wrap)
    else:
        raw = assemble_stencil_fused(coords, tris, e, nu, t, rows, cols_n, wrap)
    reduced = _reduce_stencil(raw, free_g, wrap)

    raw_op = make_stencil_operator(raw, wrap)
    b = free_g * (f_g - raw_op((1.0 - free_g) * u_fixed_g)) + (
        1.0 - free_g
    ) * u_fixed_g

    if spec.refine:
        from .refine import mixed_precision_solve

        reduced32 = reduced.astype(jnp.float32)
        op64 = make_stencil_operator(reduced, wrap)
        op32 = make_stencil_operator(reduced32, wrap)
        precond32 = _stencil_preconditioner(
            spec, reduced32, free_g.astype(jnp.float32), wrap
        )
        result = mixed_precision_solve(
            op64,
            op32,
            b,
            preconditioner32=precond32,
            x0=u_fixed_g,
            rtol=spec.rtol,
            atol=spec.atol,
            inner_maxiter=spec.refine_inner_iters,
            max_outer=spec.refine_max_outer,
        )
        x, iters = result.x, result.inner_iterations
    else:
        op = make_stencil_operator(reduced, wrap)
        precond = _stencil_preconditioner(spec, reduced, free_g, wrap)
        result = pcg(
            op,
            b,
            preconditioner=precond,
            x0=u_fixed_g,
            rtol=spec.rtol,
            atol=spec.atol,
            maxiter=spec.maxiter,
            **_observe_kwargs(spec),
        )
        x, iters = result.x, result.iterations

    u = _ungrid(x)
    ku = _ungrid(raw_op(x))
    bnorm = jnp.sqrt(jnp.sum(b * b))
    history = getattr(result, "history", None)
    if history is None or history.shape[0] != spec.history:
        history = jnp.zeros((spec.history,), dtype=b.dtype)
    return u, ku, iters, result.residual_norm, result.converged, bnorm, history


def _run_linear_solve(spec: CoreSpec, op, precond, b, x0, op32=None, precond32=None):
    """PCG or (when spec.refine) a mixed-precision scheme.

    Returns (x, iters, resnorm, converged, history). Refinement reports an
    empty history (the inner solves restart each pass).

    Two refine schemes:
      * AMG preconditioner: ONE f64 PCG whose preconditioner is the f32
        V-cycle (casts at the boundary). Outer/inner iterative refinement
        stagnates at kappa(A)*eps_f32 relative residual -- measured ~3e-6
        at 400k+ unstructured DOFs -- because the inner f32 solve targets
        the CAST operator; f64 CG against the true operator with a merely
        approximate (f32) preconditioner keeps full f64 accuracy at almost
        the same cost (the V-cycle dominates the per-iteration work and
        still runs f32).
      * otherwise: classic f64-residual / f32-inner-solve refinement.
    """
    if spec.refine and spec.preconditioner == "amg":
        f64 = b.dtype

        def precond64(r):
            # normalize before the f32 cast (mirrors refine.py): extreme
            # residual magnitudes would otherwise under/overflow the f32
            # V-cycle input; the preconditioner is linear, so rescaling the
            # output is exact
            nrm = jnp.sqrt(jnp.sum(r * r))
            safe = jnp.where(nrm == 0, 1.0, nrm)
            z = precond32((r / safe).astype(jnp.float32)).astype(f64)
            return z * safe

        result = pcg(
            op,
            b,
            preconditioner=precond64,
            x0=x0,
            rtol=spec.rtol,
            atol=spec.atol,
            maxiter=spec.maxiter,
            **_observe_kwargs(spec),
        )
        return (
            result.x,
            result.iterations,
            result.residual_norm,
            result.converged,
            result.history,
        )
    if spec.refine:
        from .refine import mixed_precision_solve

        result = mixed_precision_solve(
            op,
            op32,
            b,
            preconditioner32=precond32,
            x0=x0,
            rtol=spec.rtol,
            atol=spec.atol,
            inner_maxiter=spec.refine_inner_iters,
            max_outer=spec.refine_max_outer,
        )
        history = jnp.zeros((spec.history,), dtype=b.dtype)
        return (
            result.x,
            result.inner_iterations,
            result.residual_norm,
            result.converged,
            history,
        )
    result = pcg(
        op,
        b,
        preconditioner=precond,
        x0=x0,
        rtol=spec.rtol,
        atol=spec.atol,
        maxiter=spec.maxiter,
        **_observe_kwargs(spec),
    )
    return (
        result.x,
        result.iterations,
        result.residual_norm,
        result.converged,
        result.history,
    )


def _solve_hybrid(
    spec: CoreSpec, coords, tris, rem_idx, slot_ids, u_known, u_value, f_value, e, nu, t, amg, assembled
):
    from .dia import block_jacobi_inverse_t, make_hybrid_operator

    offsets = spec.params.offsets
    rem_rows, rem_cols = rem_idx[0], rem_idx[1]
    free_t = (~u_known).astype(coords.dtype).T  # [2, N], N minormost
    u_fixed_t = u_value.T
    f_t = f_value.T

    bands, rem_vals = assembled

    def make_op(bands_, rem_vals_, free_):
        matvec = make_hybrid_operator(
            bands_, offsets, rem_vals_, rem_rows, rem_cols
        )

        def op(v):
            return free_ * matvec(free_ * v) + (1.0 - free_) * v

        return matvec, op

    matvec_t, op = make_op(bands, rem_vals, free_t)
    zero_idx = offsets.index(0)
    if spec.preconditioner == "none":
        precond = identity_preconditioner()
    else:
        precond = block_jacobi_inverse_t(bands[zero_idx], free_t)
        if spec.preconditioner == "amg" and not spec.refine:
            from .amg import make_amg_preconditioner

            precond = make_amg_preconditioner(
                amg, op, precond, layout="t",
                a_op=lambda v: free_t * matvec_t(free_t * v),
                **_amg_sweep_kwargs(spec),
            )
    op32 = precond32 = None
    if spec.refine:
        f32 = jnp.float32
        free32 = free_t.astype(f32)
        bands32, rem32 = bands.astype(f32), rem_vals.astype(f32)
        matvec32, op32 = make_op(bands32, rem32, free32)
        precond32 = block_jacobi_inverse_t(bands32[zero_idx], free32)
        if spec.preconditioner == "amg":
            from .amg import make_amg_preconditioner

            precond32 = make_amg_preconditioner(
                amg, op32, precond32, layout="t",
                a_op=lambda v: free32 * matvec32(free32 * v),
                **_amg_sweep_kwargs(spec),
            )
    b = free_t * (f_t - matvec_t(u_fixed_t)) + (1.0 - free_t) * u_fixed_t
    x, iters, resnorm, converged, history = _run_linear_solve(
        spec, op, precond, b, u_fixed_t, op32, precond32
    )
    return (
        x.T,
        matvec_t(x).T,
        iters,
        resnorm,
        converged,
        jnp.sqrt(jnp.sum(b * b)),
        history,
    )


def _solve_dia(spec: CoreSpec, coords, tris, slot_ids, u_known, u_value, f_value, e, nu, t, amg, assembled):
    from .dia import (
        block_jacobi_inverse_t,
        dia_diag_blocks,
        make_dia_operator,
    )

    offsets = spec.params.offsets
    free_t = (~u_known).astype(coords.dtype).T
    u_fixed_t = u_value.T
    f_t = f_value.T

    (bands,) = assembled

    def make_op(bands_, free_):
        matvec = make_dia_operator(bands_, offsets)

        def op(v):
            return free_ * matvec(free_ * v) + (1.0 - free_) * v

        return matvec, op

    matvec_t, op = make_op(bands, free_t)
    if spec.preconditioner == "none":
        precond = identity_preconditioner()
    else:
        precond = block_jacobi_inverse_t(dia_diag_blocks(bands, offsets), free_t)
        if spec.preconditioner == "amg" and not spec.refine:
            from .amg import make_amg_preconditioner

            precond = make_amg_preconditioner(
                amg, op, precond, layout="t",
                a_op=lambda v: free_t * matvec_t(free_t * v),
                **_amg_sweep_kwargs(spec),
            )
    op32 = precond32 = None
    if spec.refine:
        f32 = jnp.float32
        free32 = free_t.astype(f32)
        bands32 = bands.astype(f32)
        matvec32, op32 = make_op(bands32, free32)
        precond32 = block_jacobi_inverse_t(
            dia_diag_blocks(bands32, offsets), free32
        )
        if spec.preconditioner == "amg":
            from .amg import make_amg_preconditioner

            precond32 = make_amg_preconditioner(
                amg, op32, precond32, layout="t",
                a_op=lambda v: free32 * matvec32(free32 * v),
                **_amg_sweep_kwargs(spec),
            )
    b = free_t * (f_t - matvec_t(u_fixed_t)) + (1.0 - free_t) * u_fixed_t
    x, iters, resnorm, converged, history = _run_linear_solve(
        spec, op, precond, b, u_fixed_t, op32, precond32
    )
    return (
        x.T,
        matvec_t(x).T,
        iters,
        resnorm,
        converged,
        jnp.sqrt(jnp.sum(b * b)),
        history,
    )


def _solve_dense(spec: CoreSpec, coords, tris, u_known, u_value, f_value, e, nu, t):
    n = coords.shape[0]
    free = (~u_known).astype(coords.dtype)
    ke = element_stiffness_matrices(coords, tris, e, nu, t)
    kmat = assemble_dense(ke, tris, n)
    free_f = free.reshape(-1)
    a = kmat * (free_f[:, None] * free_f[None, :]) + jnp.diag(1.0 - free_f)
    # pinned: an f32 product would otherwise be allowed TF32 on the GPU
    kmat_dot = lambda v: jnp.matmul(kmat, v, precision="highest")
    b = free_f * (f_value.reshape(-1) - kmat_dot(u_value.reshape(-1))) + (
        1.0 - free_f
    ) * u_value.reshape(-1)
    u_flat = jnp.linalg.solve(a, b)
    u = u_flat.reshape(-1, 2)
    ku = kmat_dot(u_flat).reshape(-1, 2)
    resnorm = jnp.linalg.norm(free * (f_value - ku))
    return (
        u, ku, jnp.int32(0), resnorm, jnp.bool_(True), jnp.linalg.norm(b),
        jnp.zeros((spec.history,), dtype=b.dtype),
    )


def _solve_ell(spec: CoreSpec, coords, tris, cols, slot_ids, u_known, u_value, f_value, e, nu, t, amg, assembled):
    free = (~u_known).astype(coords.dtype)
    (ell,) = assembled
    matvec = make_ell_operator(ell, cols)
    op = make_constrained_operator(matvec, free)
    diag_blocks = extract_block_diagonal(ell, cols)
    if spec.preconditioner == "amg" and not spec.refine:
        # (under refine the amg arrays are f32 and only precond32 is used)
        from .amg import make_amg_preconditioner

        bj = block_jacobi_preconditioner(diag_blocks, free)
        precond = make_amg_preconditioner(
            amg, op, bj, layout="n",
            a_op=lambda v: free * matvec(free * v),
            **_amg_sweep_kwargs(spec),
        )
    else:
        precond = _make_preconditioner(
            "block_jacobi" if spec.preconditioner == "amg" else spec.preconditioner,
            diag_blocks,
            free,
        )
    b = reduced_rhs(matvec, free, u_value, f_value)
    if spec.refine:
        f32 = jnp.float32
        free32 = free.astype(f32)
        ell32 = ell.astype(f32)
        matvec32 = make_ell_operator(ell32, cols)
        op32 = make_constrained_operator(matvec32, free32)
        if spec.preconditioner == "amg":
            from .amg import make_amg_preconditioner

            bj32 = block_jacobi_preconditioner(diag_blocks.astype(f32), free32)
            precond32 = make_amg_preconditioner(
                amg, op32, bj32, layout="n",
                a_op=lambda v: free32 * matvec32(free32 * v),
                **_amg_sweep_kwargs(spec),
            )
        else:
            precond32 = _make_preconditioner(
                spec.preconditioner, diag_blocks.astype(f32), free32
            )
        x, iters, resnorm, converged, history = _run_linear_solve(
            spec, op, precond, b, u_value, op32, precond32
        )
        return (
            x,
            matvec(x),
            iters,
            resnorm,
            converged,
            jnp.sqrt(jnp.sum(b * b)),
            history,
        )
    result = pcg(
        op,
        b,
        preconditioner=precond,
        x0=u_value,  # satisfies the fixed DOFs exactly
        rtol=spec.rtol,
        atol=spec.atol,
        maxiter=spec.maxiter,
        **_observe_kwargs(spec),
    )
    return (
        result.x,
        matvec(result.x),
        result.iterations,
        result.residual_norm,
        result.converged,
        jnp.sqrt(jnp.sum(b * b)),
        result.history,
    )


@dataclass
class OperatorCache:
    """A persisted compile-time assembly product (persist.save_operator).

    Holds the slot-major flat [n_slots, 4] f64 stiffness values the
    irregular formats assemble once at compile time, keyed by the
    INPUT-ORDER mesh identity (fem/amg.mesh_state_hash) + material. A
    resumed compile that matches skips structure build, renumbering, and
    the ~1.5 s C++ closed-form assembly: prep becomes one chunked upload.
    The reference has no analog -- it re-assembles dense K on every run
    (/root/reference/src/solver.rs:290-331)."""

    mesh_hash: str
    material: tuple  # (youngs_modulus, poisson_ratio, part_thickness)
    mode: str  # "dia" | "hybrid" | "ell"
    offsets: tuple  # band offsets (dia/hybrid); () for ell
    flat: np.ndarray  # [n_slots, 4] f64 slot-major assembled values
    cols: Optional[np.ndarray]  # hybrid rem idx [2, R] / ell cols [n, w]
    perm: Optional[np.ndarray]  # renumbering applied at compile, if any
    # True: `flat` holds only the d >= 0 band slots (+ hybrid remainder);
    # the negative bands rebuild on device from block symmetry. Halves
    # the pinned host copy, the npz on disk, and the upload.
    sym_half: bool = False

    def matches(self, mesh_hash: str, metadata) -> bool:
        mat = (
            float(metadata.youngs_modulus),
            float(metadata.poisson_ratio),
            float(metadata.part_thickness),
        )
        return self.mesh_hash == mesh_hash and tuple(self.material) == mat


def _assemble_host_flat(mode: str, params, mesh, cols, slot_ids, metadata):
    """Host C++ closed-form assembly, slot-major flat [S, 4] (or None).

    One pass over elements scatter-adding the four 2x2-block component
    fields through the precomputed slot ids (the same native kernel the AMG
    setup uses, with an all-ones mask = unreduced operator)."""
    from ..native import amg_assemble

    n = mesh.num_nodes
    e_count = mesh.tris.shape[0]
    if mode == "dia":
        n_slots = len(params.offsets) * n
    elif mode == "hybrid":
        n_slots = len(params.offsets) * n + cols.shape[1]
    else:
        n_slots = n * cols.shape[1]
    slots_pm = (
        np.asarray(slot_ids, np.int64)
        .reshape(e_count, 3, 3)
        .transpose(1, 2, 0)
        .reshape(-1)
    )
    return amg_assemble(
        mesh.coords,
        mesh.tris,
        np.ones((n, 2)),
        metadata.youngs_modulus,
        metadata.poisson_ratio,
        metadata.part_thickness,
        slots_pm,
        n_slots,
    )


def _assemble_host(mode: str, params, mesh, cols, slot_ids, metadata):
    """Host C++ assembly in the operator's band-major HOST layout.

    Pays a strided host transpose for dia/hybrid (the sharded prepare needs
    host arrays to pad + lay out); the single-chip compile path uses
    `_assemble_host_device` instead, which keeps the relayout on device."""
    flat = _assemble_host_flat(mode, params, mesh, cols, slot_ids, metadata)
    if flat is None:
        return None
    n = mesh.num_nodes
    if mode == "dia":
        d = len(params.offsets)
        return (flat.reshape(d, n, 2, 2).transpose(0, 2, 3, 1),)
    if mode == "hybrid":
        d = len(params.offsets)
        bands = flat[: d * n].reshape(d, n, 2, 2).transpose(0, 2, 3, 1)
        return bands, flat[d * n :].reshape(-1, 2, 2)
    return (flat.reshape(n, cols.shape[1], 2, 2),)


def _assemble_host_device(
    mode: str, params, mesh, cols, slot_ids, metadata, upload_dtype
):
    """C++ assembly uploaded flat + relaid out on DEVICE.

    The slot-major [S, 4] result uploads contiguously (converted to the
    upload dtype on host first -- halves the bytes for f32) and the
    band-major relayout runs as a device transpose: the host-side
    `.transpose(0, 2, 3, 1)` copy of ~650 MB measured 7-15 s on a 1-core
    box (strided doubles, cache-hostile) vs milliseconds on device.
    Returns device arrays matching `_assembly_core`'s outputs, or None
    when the native library is unavailable.
    """
    flat = _assemble_host_flat(mode, params, mesh, cols, slot_ids, metadata)
    if flat is None:
        return None
    return _upload_flat_device(
        mode, params, mesh.num_nodes, cols, flat, upload_dtype
    )


def _sym_half_offsets(mode: str, params) -> Optional[tuple]:
    """The negative band offsets when the symmetric-half layout applies
    (dia/hybrid with a sign-symmetric offset set), else None."""
    if mode not in ("dia", "hybrid"):
        return None
    offsets = tuple(int(o) for o in params.offsets)
    neg = tuple(o for o in offsets if o < 0)
    if neg and all(-o in offsets for o in neg):
        return neg
    return None


def _upload_flat_device(
    mode: str, params, n, cols, flat, upload_dtype, flat_is_half=False
):
    """Upload a slot-major flat assembly + relay out on device (see
    `_assemble_host_device`); also the resume path for a matching
    persisted OperatorCache (whose `flat` may already be the half slice:
    `flat_is_half`).

    Symmetric-half upload (dia/hybrid): the unreduced stiffness is
    block-symmetric, so ``band(-off)[i] = band(+off)[i - off]^T`` exactly
    (to ~1 ulp: the C++ assembly accumulates mirrored blocks element-major
    from termwise-commuted products). Offsets are sorted, so the d >= 0
    band slots -- plus the hybrid COO remainder -- are one CONTIGUOUS tail
    slice of `flat`; uploading only that tail halves the bytes
    (~656 MB -> ~336 MB f64 at 1M elements) and the negative bands are
    rebuilt on device with static rolls + 2x2 transposes (milliseconds).
    Falls back to the full upload when any negative offset lacks its
    mirror (sign-asymmetric legacy hybrid band selections).
    """
    offsets = tuple(int(o) for o in params.offsets) if mode != "ell" else ()
    neg = _sym_half_offsets(mode, params) or ()
    if flat_is_half and not neg:
        raise InputError(
            "operator cache holds a symmetric-half assembly but the offset "
            "set is not sign-symmetric; the cache file is corrupt"
        )
    if neg:
        d, d0 = len(offsets), len(neg)
        pos_offsets = offsets[d0:]
        # contiguous: pos bands (+ hybrid remainder)
        half = flat if flat_is_half else flat[d0 * n :]
        if half.dtype != upload_dtype:
            half = half.astype(upload_dtype)
        half_d = jax.device_put(half)

        def rebuild_bands(h):
            bands_pos = h[: (d - d0) * n].reshape(d - d0, n, 2, 2)
            neg_parts = []
            for o in neg:  # ascending negatives match sorted offsets
                bp = bands_pos[pos_offsets.index(-o)]
                # band(o)[i] = band(-o)[i + o]^T; roll wrap lands on the
                # zero guard rows of the positive band (i + (-o) >= n)
                neg_parts.append(
                    jnp.roll(bp, -o, axis=0).transpose(0, 2, 1)
                )
            full = jnp.concatenate([jnp.stack(neg_parts), bands_pos], 0)
            return full.transpose(0, 2, 3, 1)  # [d, 2, 2, n]

        if mode == "dia":
            return (jax.jit(rebuild_bands)(half_d),)
        bands, rem = jax.jit(
            lambda h: (
                rebuild_bands(h),
                h[(d - d0) * n :].reshape(-1, 2, 2),
            )
        )(half_d)
        return bands, rem

    if flat.dtype != upload_dtype:
        flat = flat.astype(upload_dtype)
    flat_d = jax.device_put(flat)

    if mode == "dia":
        d = len(params.offsets)
        bands = jax.jit(
            lambda f: f.reshape(d, n, 2, 2).transpose(0, 2, 3, 1)
        )(flat_d)
        return (bands,)
    if mode == "hybrid":
        d = len(params.offsets)
        bands, rem = jax.jit(
            lambda f: (
                f[: d * n * 4]
                .reshape(d, n, 2, 2)
                .transpose(0, 2, 3, 1),
                f[d * n * 4 :].reshape(-1, 2, 2),
            )
        )(flat_d.reshape(-1))
        return bands, rem
    return (flat_d.reshape(n, cols.shape[1], 2, 2),)


@lru_cache(maxsize=32)
def _assembly_core(mode: str, params):
    """Compile-time operator assembly for the irregular formats.

    Assembly depends only on a CompiledProblem's fixed operands, so it runs
    ONCE when the problem is compiled; solve calls start from the resident
    assembled arrays. (The f64 segment_sum scatter behind mixed-precision
    refinement costs more than the whole preconditioned solve, so
    re-running it per solve would dominate.) The stencil
    path keeps its fused in-solve assembly: structured scatter-free
    assembly is a few rolls/FMAs."""

    def asm(coords, tris, cols, slot_ids, e, nu, t):
        from .dia import assemble_dia_fused, assemble_hybrid_fused

        n = coords.shape[0]
        if mode == "dia":
            return (
                assemble_dia_fused(
                    coords, tris, e, nu, t, slot_ids, n,
                    len(params.offsets),
                ),
            )
        if mode == "hybrid":
            return assemble_hybrid_fused(
                coords, tris, e, nu, t, slot_ids, n,
                len(params.offsets), cols.shape[1],
            )
        return (
            assemble_ell_arrays_fused(
                coords, tris, e, nu, t, slot_ids, n, cols.shape[1]
            ),
        )

    return jax.jit(asm)


@lru_cache(maxsize=32)
def _jitted_core(spec: CoreSpec):
    """Build + cache the jitted solve core for one CoreSpec."""

    def core(coords, tris, cols, slot_ids, u_known, u_value, f_value, e, nu, t, amg, assembled):
        if spec.mode == "stencil":
            u, ku, iters, resnorm, converged, bnorm, history = _solve_stencil(
                spec, coords, tris, u_known, u_value, f_value, e, nu, t
            )
        elif spec.mode == "hybrid":
            u, ku, iters, resnorm, converged, bnorm, history = _solve_hybrid(
                spec, coords, tris, cols, slot_ids, u_known, u_value, f_value, e, nu, t, amg, assembled
            )
        elif spec.mode == "dia":
            u, ku, iters, resnorm, converged, bnorm, history = _solve_dia(
                spec, coords, tris, slot_ids, u_known, u_value, f_value, e, nu, t, amg, assembled
            )
        elif spec.mode == "dense":
            u, ku, iters, resnorm, converged, bnorm, history = _solve_dense(
                spec, coords, tris, u_known, u_value, f_value, e, nu, t
            )
        else:
            u, ku, iters, resnorm, converged, bnorm, history = _solve_ell(
                spec, coords, tris, cols, slot_ids, u_known, u_value, f_value, e, nu, t, amg, assembled
            )

        # Force recovery: unknown forces are K u rows (reference
        # src/solver.rs:457-469); known applied forces pass through.
        f = jnp.where(u_known, ku, f_value)
        # in the solution's dtype (f64 under refinement): strain differences
        # u across an element, and an f32 cast of u would cost the stress
        # ~eps_f32 * extent / h of relative accuracy (1e-5 at 50k elements)
        sigma = element_stress_tensors(coords, tris, u, e, nu)
        stress = scalar_stress(sigma, sign_threshold=spec.stress_sign_threshold)
        vm = von_mises_stress(sigma)
        return u, f, sigma, stress, vm, iters, resnorm, converged, bnorm, history

    return jax.jit(core)


def assemble_ell_arrays(ke, slot_ids, n_nodes: int, width: int):
    """Array-level ELL assembly (jit-friendly form of `assemble_ell`)."""
    from .assembly import element_blocks

    blocks = element_blocks(ke)
    flat = jax.ops.segment_sum(blocks, slot_ids, num_segments=n_nodes * width)
    return flat.reshape(n_nodes, width, 2, 2)


def assemble_ell_arrays_fused(coords, tris, e, nu, t, slot_ids, n_nodes: int, width: int):
    """ELL assembly from closed-form scalar pair fields (no [E,6,6] tensor;
    see fem/dia.assemble_dia_fused)."""
    from .dia import _pair_major_slots, _scatter_fields
    from .element import pair_block_fields

    fields = pair_block_fields(coords, tris, e, nu, t)
    slots = _pair_major_slots(slot_ids, tris.shape[0])
    flat = _scatter_fields(fields, slots, n_nodes * width)  # [2,2,N*K]
    return flat.reshape(2, 2, n_nodes, width).transpose(2, 3, 0, 1)


def solve_system(
    mesh: Mesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    options: SolverOptions = SolverOptions(),
    structure: Optional[EllStructure] = None,
    amg_setup=None,
    device_mesh=None,
) -> SolveResult:
    """Full FEA solve of one mesh + boundary-condition set.

    One-shot convenience wrapper around `compile_problem` -- repeated solves
    of the same mesh should hold onto a CompiledProblem instead (device
    arrays stay resident; only the jit call repeats).

    `device_mesh`: a 1D `jax.sharding.Mesh` routes the whole pipeline --
    solve, force recovery, stress recovery -- through the sharded multi-chip
    path (parallel/pipeline.py); results are identical to the single-chip
    path up to solver tolerance.
    """
    if device_mesh is not None:
        from ..parallel.pipeline import compile_sharded_problem

        return compile_sharded_problem(
            mesh, bca, metadata, options,
            device_mesh=device_mesh, amg_setup=amg_setup,
        ).solve()
    problem = compile_problem(mesh, bca, metadata, options, structure, amg_setup)
    return problem.solve()


@dataclass
class CompiledProblem:
    """A mesh+BC system compiled and resident on device.

    `solve()` runs the device pipeline and fetches results to host.
    `solve_device()` returns the raw device outputs (u, f, sigma, stress,
    von_mises, iters, resnorm, converged) without any host transfer -- the
    serving/benchmark path. Irregular operator formats (dia/hybrid/ell)
    assemble once at compile time (timings["assemble_s"]) and solves start
    from the resident operator; the stencil format assembles in-solve
    (scatter-free, a few rolls/FMAs).
    """

    core: object
    args: tuple
    mode: str
    preconditioner: str
    timings: dict
    refine: bool = False
    debug_nans: bool = False
    # internal node renumbering (meshing/reorder.py): perm[new] = old.
    # `solve()` reports results in the caller's original node order;
    # `solve_device()` returns raw arrays in the renumbered order.
    perm: Optional[np.ndarray] = None
    # the AMG hierarchy built (or reused) for this problem; persist it with
    # persist.save_amg so re-runs skip the host setup
    amg_setup: object = None
    # the host-side assembled operator (irregular formats, host C++ path);
    # persist with persist.save_operator so re-runs skip assembly too
    operator_host: object = None

    def solve_device(self):
        return self.core(*self.args)

    def solve(self) -> SolveResult:
        timings = dict(self.timings)
        t0 = time.perf_counter()
        out = self.core(*self.args)
        u, f, sigma, stress, vm, iters, resnorm, converged, bnorm, history = (
            jax.block_until_ready(out)
        )
        timings["solve_s"] = time.perf_counter() - t0

        u, f, sigma = np.asarray(u), np.asarray(f), np.asarray(sigma)
        if self.perm is not None:
            # new node i is original node perm[i]; element order is unchanged
            u_o, f_o = np.empty_like(u), np.empty_like(f)
            u_o[self.perm], f_o[self.perm] = u, f
            u, f = u_o, f_o
        # NaN check first: a NaN residual also reads as "not converged", but
        # the sanitizer message is the actionable one
        if self.debug_nans:
            for name, arr in (("displacements", u), ("forces", f), ("stresses", sigma)):
                if not np.isfinite(arr).all():
                    raise SolverError(
                        f"non-finite values in solved {name} "
                        "(debug_nans): check material properties, mesh "
                        "quality, and boundary conditions"
                    )
        if not bool(converged):
            raise SolverError(
                f"conjugate gradient failed to converge in {int(iters)} "
                f"iterations (residual norm {float(resnorm):.3e})"
            )
        return SolveResult(
            u=u,
            f=f,
            sigma=sigma,
            stress=np.asarray(stress),
            von_mises=np.asarray(vm),
            iterations=int(iters),
            residual_norm=float(resnorm),
            residual_rel=float(resnorm) / max(float(bnorm), 1e-300),
            converged=True,
            timings=timings,
            residual_history=np.asarray(history)[: int(iters)],
        )


def _f32_rtol_floor() -> float:
    return 50 * float(np.finfo(np.float32).eps)


def compile_problem(
    mesh: Mesh,
    bca: BCArrays,
    metadata: ModelMetadata,
    options: SolverOptions = SolverOptions(),
    structure: Optional[EllStructure] = None,
    amg_setup=None,
    operator_cache: Optional[OperatorCache] = None,
) -> CompiledProblem:
    """Select the operator format, build/cache the jitted core, upload args.

    `amg_setup`: a previously built fem/amg.AMGSetup for THIS problem
    (persist.save_amg/load_amg) -- skips the hierarchy build, the dominant
    host cost for large unstructured meshes. It must come from the same
    mesh + BC mask + material under the same options (renumbering is
    deterministic, so a setup saved from a compiled problem matches the
    re-compiled one); a node-count mismatch triggers a silent rebuild.

    `operator_cache`: a persisted assembled operator for THIS mesh +
    material (persist.save_operator/load_operator) -- skips structure
    build, renumbering, and the host C++ assembly; a mismatch (different
    mesh bytes, BC mask, or material) is warned about and ignored.
    """
    from ..utils.jaxcache import ensure_default_cache

    ensure_default_cache()
    timings: dict = {}
    dtype = default_dtype(options)
    n = mesh.num_nodes

    if not bca.u_known.any():
        raise SolverError(
            "model has no prescribed displacements; stiffness system is singular"
        )

    t0 = time.perf_counter()
    mode = "dense" if n <= options.dense_cutoff else None
    params = None
    cols = np.zeros((1, 1), dtype=np.int32)
    slot_ids = np.zeros(1, dtype=np.int32)
    if (
        mode is None
        and options.operator in ("auto", "stencil")
        and mesh.grid_shape is not None
    ):
        rows_g, cols_g = mesh.grid_shape
        ok = mesh.grid_local
        if not ok:
            # untrusted producer: host scan verifies every coupling is
            # grid-local before committing to the stencil operator
            from .stencil import build_stencil_structure

            ok = (
                build_stencil_structure(
                    mesh.tris, rows_g, cols_g, mesh.wrap_cols
                )
                is not None
            )
        if ok:
            # scatter pattern is built on device from tris; nothing uploaded
            mode = "stencil"
            params = StencilParams(
                rows_g, cols_g, mesh.wrap_cols, mesh.canonical_grid
            )
        elif options.operator == "stencil":
            raise SolverError(
                "mesh connectivity is not grid-local; stencil operator "
                "unavailable"
            )
    # Irregular-format path: hash the INPUT-ORDER mesh + BC mask once.
    # Shared by the operator-cache check, the AMG fingerprint (when no
    # renumbering intervenes), and the operator cache a later
    # persist.save_operator writes.
    perm = None
    input_mesh_hash = None
    if mode is None:
        from .amg import mesh_state_hash

        input_mesh_hash = mesh_state_hash(
            mesh.coords, mesh.tris, (~bca.u_known).astype(np.float64)
        )
    if (
        mode is None
        and operator_cache is not None
        and operator_cache.perm is not None
        and options.renumber == "off"
    ):
        from ..utils.logging import log

        log(
            "warning: operator cache was assembled under a renumbering "
            "but renumber='off' pins the input order; re-assembling"
        )
        operator_cache = None
        timings["operator_cache"] = "miss"
    if (
        mode is None
        and operator_cache is not None
        and options.operator in ("auto", operator_cache.mode)
    ):
        if operator_cache.matches(input_mesh_hash, metadata):
            mode = operator_cache.mode
            if operator_cache.perm is not None:
                from ..meshing.reorder import apply_permutation

                perm = np.asarray(operator_cache.perm)
                mesh = apply_permutation(mesh, perm)
                bca = BCArrays(
                    u_known=bca.u_known[perm],
                    u_value=bca.u_value[perm],
                    f_value=bca.f_value[perm],
                )
            if mode == "dia":
                params = DiaParams(tuple(int(o) for o in operator_cache.offsets))
            elif mode == "hybrid":
                params = HybridParams(
                    tuple(int(o) for o in operator_cache.offsets)
                )
                cols = np.asarray(operator_cache.cols, dtype=np.int32)
            else:  # ell
                cols = np.asarray(operator_cache.cols, dtype=np.int32)
            timings["operator_cache"] = "hit"
        else:
            from ..utils.logging import log

            log(
                "warning: provided operator cache does not match this "
                "problem (mesh bytes, BC mask, or material); re-assembling"
            )
            operator_cache = None
            timings["operator_cache"] = "miss"

    # Band-friendly renumbering: a mesh whose native node order misses the
    # DIA band format (arbitrary .msh input, shuffled producers) gets a
    # geometric/RCM renumbering (meshing/reorder.py) before the format
    # choice commits -- results are un-permuted on the way out. Skipped when
    # the caller pinned an ELL structure (its slot_ids encode the ordering).
    if (
        mode is None
        and options.renumber != "off"
        and structure is None
        and options.operator in ("auto", "dia", "hybrid")
    ):
        from ..meshing.reorder import band_stats, renumber as _renumber
        from .dia import build_dia_structure

        if build_dia_structure(mesh.tris, n, max_diags=options.max_diags) is None:
            orig = band_stats(mesh.tris, top_k=options.max_diags)
            mesh_r, perm_r, stats = _renumber(
                mesh, method=options.renumber, top_k=options.max_diags
            )
            if (
                stats.n_offsets <= options.max_diags < orig.n_offsets
                or stats.remainder_frac < orig.remainder_frac
            ):
                from ..utils.logging import log

                log(
                    "info: renumbered nodes for banded SpMV: "
                    f"{orig.n_offsets} -> {stats.n_offsets} distinct "
                    "offsets, out-of-band remainder "
                    f"{orig.remainder_frac:.1%} -> {stats.remainder_frac:.1%}"
                )
                mesh, perm = mesh_r, perm_r
                bca = BCArrays(
                    u_known=bca.u_known[perm],
                    u_value=bca.u_value[perm],
                    f_value=bca.f_value[perm],
                )

    if mode is None and options.operator in ("auto", "dia"):
        from .dia import build_dia_structure

        dia = build_dia_structure(mesh.tris, n, max_diags=options.max_diags)
        if dia is not None:
            mode = "dia"
            slot_ids = dia.slot_ids
            params = DiaParams(tuple(int(o) for o in dia.offsets))
        elif options.operator == "dia":
            raise SolverError(
                f"mesh needs more than {options.max_diags} diagonal bands; "
                "use operator='ell' or renumber the mesh"
            )
    if mode is None and options.operator in ("auto", "hybrid"):
        from .dia import build_hybrid_structure

        hyb = build_hybrid_structure(mesh.tris, n, max_diags=options.max_diags)
        mode = "hybrid"
        slot_ids = hyb.slot_ids
        params = HybridParams(tuple(int(o) for o in hyb.offsets))
        cols = np.stack([hyb.rem_rows, hyb.rem_cols]).astype(np.int32)
        if cols.shape[1] == 0:  # fully banded after all
            cols = np.zeros((2, 1), dtype=np.int32)
    if mode is None:
        mode = "ell"
        if structure is None:
            structure = build_ell_structure(mesh.tris, n)
        cols = structure.cols
        slot_ids = structure.slot_ids
    timings["structure_s"] = time.perf_counter() - t0
    timings["operator"] = mode

    # Tolerance vs working precision: f32 cannot reach f64-grade residuals.
    # With x64 available and a stencil operator, mixed-precision iterative
    # refinement (f64 residual + f32 inner solves) reaches the requested
    # tolerance anyway; otherwise the tolerance is clamped to ~50 eps.
    rtol = float(options.cg_rtol)
    refine = False
    x64 = bool(jax.config.jax_enable_x64)
    if options.refine == "on" and mode != "dense":
        if not x64:
            raise SolverError(
                "refine='on' requires jax_enable_x64 (f64 residuals)"
            )
        refine = True
    elif (
        # "auto" engages only for the stencil operator: its scatter-free
        # f64 assembly is cheap at any scale, while the irregular formats'
        # f64 element tensors can blow up compilation on 1M+ meshes --
        # those opt in explicitly with refine="on"
        mode == "stencil"
        and options.refine == "auto"
        and x64
        and dtype == np.float32
        and rtol < _f32_rtol_floor()
    ):
        refine = True
    if not refine and dtype == np.float32:
        floor = _f32_rtol_floor()
        if rtol < floor:
            from ..utils.logging import log

            log(
                f"warning: requested cg_rtol {rtol:.1e} is below the f32 "
                f"floor; clamping to {floor:.1e} (use refine='on' / CLI "
                "--precision mixed for f64-grade residuals)"
            )
        rtol = max(rtol, floor)

    preconditioner = options.preconditioner
    if preconditioner == "auto":
        if mode == "stencil":
            from .multigrid import can_coarsen

            preconditioner = (
                "multigrid"
                if can_coarsen(params.rows, params.cols, params.wrap)
                else "block_jacobi"
            )
        else:
            # unstructured at scale: smoothed-aggregation AMG holds CG
            # iteration counts mesh-independent (fem/amg.py); below the
            # threshold the hierarchy setup outweighs the saved iterations.
            # TINY meshes (n*2 under the dense-coarsest cap) get "amg" too:
            # there build_amg_setup degenerates to one exact dense inverse
            # (a single [2N, 2N] dense matmul per apply, ~2 CG iterations vs
            # the O(1/h) block-Jacobi counts -- 170 on the 465-node
            # linkedin mesh)
            from .amg import _DENSE_COARSE_MAX_DOF

            preconditioner = (
                "amg"
                if mode in ("dia", "hybrid", "ell")
                and (
                    n >= options.amg_auto_min_nodes
                    or 2 * n <= _DENSE_COARSE_MAX_DOF
                )
                else "block_jacobi"
            )
    elif preconditioner == "multigrid" and mode != "stencil":
        raise SolverError(
            "multigrid preconditioner requires a structured-grid mesh "
            "(stencil operator)"
        )
    elif preconditioner == "amg" and mode not in ("dia", "hybrid", "ell"):
        raise SolverError(
            "amg preconditioner applies to unstructured operators "
            "(dia/hybrid/ell); structured grids use preconditioner="
            "'multigrid'"
        )
    timings["preconditioner"] = preconditioner

    # refinement computes the operator + residual in f64, inner solves f32
    upload_dtype = np.dtype(np.float64) if refine else dtype

    # ---- operator assembly FIRST, upload issued async: the flat operator
    # (up to ~336 MB f64 at 1M elements) copies to the device WHILE the
    # AMG hierarchy builds on host below -- the two are independent, so
    # prep costs roughly their max rather than their sum. The single sync
    # point is at the end.
    assembled = ()
    operator_host = None
    flat_host = None
    flat_is_half = False
    asm_mode = str(options.assembly)
    if mode in ("dia", "hybrid", "ell"):
        t0 = time.perf_counter()
        resumed_op = (
            operator_cache is not None and mode == operator_cache.mode
        )
        if asm_mode not in ("auto", "host", "device"):
            raise InputError(
                f"unknown assembly mode '{asm_mode}' (auto | host | device)"
            )
        if asm_mode != "device":
            flat_host = (
                operator_cache.flat
                if resumed_op
                else _assemble_host_flat(
                    mode, params, mesh, cols, slot_ids, metadata
                )
            )
        flat_is_half = bool(
            resumed_op and operator_cache.sym_half and flat_host is not None
        )
        timings["assemble_build_s"] = time.perf_counter() - t0
        if flat_host is not None:
            t_up = time.perf_counter()
            assembled = _upload_flat_device(
                mode, params, n, cols, flat_host, upload_dtype,
                flat_is_half=flat_is_half,
            )
            # issue time only -- the tail keeps streaming during the AMG
            # host build; prep_sync_s below captures the residual wait
            timings["assemble_issue_s"] = time.perf_counter() - t_up
            neg = _sym_half_offsets(mode, params)
            half_slots = (
                flat_host.shape[0]
                if flat_is_half or not neg
                else flat_host.shape[0] - len(neg) * n
            )
            timings["assemble_upload_bytes"] = int(
                half_slots
                * int(np.prod(flat_host.shape[1:]))
                * np.dtype(upload_dtype).itemsize
            )
            if input_mesh_hash is not None and options.keep_operator_host:
                # keep only the d >= 0 half when symmetry allows: halves
                # the pinned host memory (and persist.save_operator bytes)
                flat_keep = np.asarray(flat_host)
                keep_half = flat_is_half
                if neg and not flat_is_half:
                    flat_keep = flat_keep[len(neg) * n :].copy()
                    keep_half = True
                operator_host = OperatorCache(
                    mesh_hash=input_mesh_hash,
                    material=(
                        float(metadata.youngs_modulus),
                        float(metadata.poisson_ratio),
                        float(metadata.part_thickness),
                    ),
                    mode=mode,
                    offsets=tuple(params.offsets)
                    if params is not None
                    else (),
                    flat=flat_keep,
                    cols=np.asarray(cols)
                    if mode in ("hybrid", "ell")
                    else None,
                    perm=perm,
                    sym_half=keep_half,
                )

    amg_args = ((), (), (), ())
    setup = None
    if preconditioner == "amg":
        from .amg import amg_device_arrays, build_amg_setup

        from .amg import setup_matches

        t0 = time.perf_counter()
        # the input-order hash is valid post-renumber only when no
        # renumbering happened; otherwise the mesh bytes changed
        amg_hash = input_mesh_hash if perm is None else None
        setup = amg_setup
        if setup is not None and not setup_matches(
            setup,
            mesh.coords,
            mesh.tris,
            (~bca.u_known).astype(np.float64),
            metadata,
            float(options.amg_cell_factor),
            perm,
            mesh_hash=amg_hash,
        ):
            from ..utils.logging import log

            log(
                "warning: provided AMG hierarchy does not match this "
                "problem (mesh ordering, BCs, material, aggregation size, "
                "or an older cache format); rebuilding"
            )
            setup = None
        if setup is None:
            setup = build_amg_setup(
                mesh.coords,
                mesh.tris,
                metadata.youngs_modulus,
                metadata.poisson_ratio,
                metadata.part_thickness,
                (~bca.u_known).astype(np.float64),
                cell_factor=float(options.amg_cell_factor),
                mesh_hash=amg_hash,
            )
        t_host = time.perf_counter()
        # refinement runs the V-cycle only inside the f32 inner solves
        amg_dtype = np.float32 if refine else dtype
        amg_args = amg_device_arrays(setup, amg_dtype)
        t_done = time.perf_counter()
        # split host build from put ISSUE time; the in-flight tail (queued
        # behind the operator upload) lands in prep_sync_s at the single
        # sync point
        timings["amg_build_s"] = t_host - t0
        timings["amg_issue_s"] = t_done - t_host
        timings["amg_upload_bytes"] = int(
            sum(
                x.nbytes
                for x in jax.tree_util.tree_leaves(amg_args)
                if hasattr(x, "nbytes")
            )
        )
        timings["amg_levels"] = setup.level_sizes

    spec = CoreSpec(
        mode=mode,
        params=params,
        preconditioner=preconditioner,
        rtol=rtol,
        atol=float(options.cg_atol),
        maxiter=int(options.max_cg_iters),
        stress_sign_threshold=float(options.stress_sign_threshold),
        refine=refine,
        refine_inner_iters=int(options.refine_inner_iters),
        refine_max_outer=int(options.refine_max_outer),
        history=int(options.residual_history),
        progress_every=int(options.cg_progress_every),
        amg_sweeps=int(options.amg_sweeps),
    )
    core = _jitted_core(spec)

    t0 = time.perf_counter()
    # slot_ids are an ASSEMBLY input only; every solve core ignores them
    # (the operator is resident by solve time). A fixed dummy keeps the
    # core's jit signature identical across fresh and operator-cache
    # resumed compiles (and skips a ~36 MB upload); the device-assembly
    # path below uploads the real ids just for its own jit.
    args = (
        jnp.asarray(mesh.coords, dtype=upload_dtype),
        jnp.asarray(mesh.tris, dtype=jnp.int32),
        jnp.asarray(cols),
        jnp.zeros(1, dtype=jnp.int32)
        if mode in ("dia", "hybrid", "ell")
        else jnp.asarray(slot_ids),
        jnp.asarray(bca.u_known),
        jnp.asarray(bca.u_value, dtype=upload_dtype),
        jnp.asarray(bca.f_value, dtype=upload_dtype),
        upload_dtype.type(metadata.youngs_modulus),
        upload_dtype.type(metadata.poisson_ratio),
        upload_dtype.type(metadata.part_thickness),
        amg_args,
    )
    timings["upload_s"] = time.perf_counter() - t0

    # irregular formats without a host flat (native library missing, or
    # assembly="device"): fused scalar-field assembly ON DEVICE from the
    # resident mesh -- uploads nothing beyond the mesh + slot ids
    if mode in ("dia", "hybrid", "ell") and not assembled:
        t0 = time.perf_counter()
        assembled = _assembly_core(spec.mode, spec.params)(
            args[0], args[1], args[2], jnp.asarray(slot_ids),
            args[7], args[8], args[9],
        )
        timings["assemble_device_s"] = time.perf_counter() - t0

    # ONE sync point for everything issued above (operator flat, AMG
    # hierarchy, problem arrays): the uploads overlap the host builds
    # between their issue points
    t0 = time.perf_counter()
    jax.block_until_ready((args[:7], amg_args, assembled))
    timings["prep_sync_s"] = time.perf_counter() - t0
    # legacy aggregate keys (bench/readers): build + issue + residual sync
    if mode in ("dia", "hybrid", "ell"):
        timings["assemble_upload_s"] = (
            timings.get("assemble_issue_s", 0.0) + timings["prep_sync_s"]
        )
        timings["assemble_s"] = (
            timings.get("assemble_build_s", 0.0)
            + timings.get("assemble_device_s", 0.0)
            + timings["assemble_upload_s"]
        )
    if preconditioner == "amg":
        timings["amg_upload_s"] = timings.get("amg_issue_s", 0.0)
        timings["amg_setup_s"] = (
            timings["amg_build_s"] + timings["amg_upload_s"]
        )
    args = args + (assembled,)

    return CompiledProblem(
        core=core,
        args=args,
        mode=mode,
        preconditioner=preconditioner,
        timings=timings,
        refine=refine,
        debug_nans=bool(options.debug_nans),
        perm=perm,
        amg_setup=setup,
        operator_host=operator_host,
    )
