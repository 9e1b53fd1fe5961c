"""Vmapped / lane-batched design sweeps: one assembled system, thousands of
solves.

The reference solves one load case per process run. Here a batch axis turns
the solve into a design sweep over load variants (prescribed displacements /
applied forces) and stiffness scale factors (Young's modulus at fixed
Poisson ratio: K' = s*K reuses ONE assembled operator).

Three implementations, picked per mesh:
  * stencil+MG lanes (canonical coarsenable grids): fields [2, R, C, B]
    with the BATCH as the minor (lane) dimension, the stencil operator
    applied by pad-once + static slices, and ONE shared geometric-multigrid
    hierarchy preconditioning every lane exactly (the variants differ from
    the base operator only by the scale s_b, and V(s_b K)^-1 =
    (1/s_b) V(K)^-1). 20 iterations reach ~1e-6 true relative residual.
  * DIA lanes (near-structured meshes): fields [2, N, B], band SpMV
    broadcast over lanes, block-Jacobi. A naive vmap of the [N,K,2,2] ELL
    solver pads its tiny minor dims 64x and OOMs at B=4096; the
    lanes-minormost layout is why the sweep fits.
  * vmap path (fallback for unstructured meshes): jax.vmap over the
    gather-ELL solver.

Fixed-iteration PCG keeps all lanes in lockstep.

Multi-chip: design lanes are independent, so every sweep data-parallels
over a device mesh by sharding the batch axis of its inputs (GSPMD
partitions the compiled solve; results come back lane-sharded, verified in
tests/test_parallel.py::test_material_sweep_shards_over_lanes). 2D
batch x rows sharding for the ELL path lives in parallel/sharding.py.
"""

from __future__ import annotations

from dataclasses import dataclass
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp
import numpy as np

from ..bc import BCArrays
from ..config import ModelMetadata
from ..fem.assembly import build_ell_structure
from ..fem.cg import pcg_fixed_iterations
from ..fem.dia import assemble_dia, build_dia_structure
from ..fem.element import element_stiffness_matrices
from ..fem.operator import (
    block_jacobi_preconditioner,
    make_constrained_operator,
    make_ell_operator,
    reduced_rhs,
)
from ..fem.solve import assemble_ell_arrays
from ..fem.stress import element_stress_tensors, von_mises_stress
from ..meshing.core import Mesh


class SweepResult(NamedTuple):
    u: jax.Array  # [B, N, 2]
    residual_norm: jax.Array  # [B] absolute ||b - K u|| per lane
    von_mises: jax.Array  # [B, E]
    rhs_norm: jax.Array = None  # [B] ||b|| per lane (relative-residual scale)


# ----------------------------- lanes path ---------------------------------


def _lane_dot(a: jax.Array, b: jax.Array) -> jax.Array:
    """Per-lane inner product: [2, N, B] x [2, N, B] -> [B]."""
    return jnp.sum(a * b, axis=(0, 1))


# Lane sharding over a device mesh. Every lanes-path solve is data-parallel
# across the batch axis (per-lane dots, broadcast operators, a shared
# hierarchy): no lane ever reads another lane. Sharding the inputs' batch
# dim over a jax.sharding.Mesh therefore partitions the WHOLE solve with
# zero collectives -- XLA propagates the sharding through every [.., B]
# intermediate -- turning one chip's sweep throughput into n_devices x.


def _replicate_tree(device_mesh, tree):
    """device_put every array leaf fully replicated over the mesh.

    Compiled setup arrays start committed to the default device; mixing
    single-device and mesh-sharded operands in one jit is an error, so the
    persistent operands must be explicitly replicated."""
    from jax.sharding import NamedSharding, PartitionSpec

    return jax.device_put(tree, NamedSharding(device_mesh, PartitionSpec()))


def _shard_lanes(device_mesh, arr, dtype):
    """Upload a [B, ...] host batch sharded on its lane axis.

    The lane axis is split over EVERY mesh axis (their product), so both
    1D and 2D meshes work. B must divide evenly -- lanes are cheap, pad
    the batch with a repeated variant rather than forcing ragged shards."""
    import math

    from jax.sharding import NamedSharding, PartitionSpec

    arr = np.asarray(arr, dtype=dtype)
    n_dev = math.prod(device_mesh.devices.shape)
    if arr.shape[0] % n_dev:
        raise ValueError(
            f"sweep batch of {arr.shape[0]} lanes does not divide over "
            f"{n_dev} devices; pad the batch to a multiple (repeating a "
            "variant is free)"
        )
    spec = PartitionSpec(device_mesh.axis_names)
    return jax.device_put(arr, NamedSharding(device_mesh, spec))


def _factor_fields(u_base, f_base, u_factors, f_factors):
    """[N, 2] base BC values x per-lane [B] load factors -> [B, N, 2]
    lane fields, built ON DEVICE inside the caller's jit.

    Load-factor sweeps (the dominant design-sweep shape: same BC regions,
    per-variant magnitudes) upload two [B] scalar vectors instead of two
    dense [B, N, 2] batches -- ~100 MB per 4096-lane batch on the 3.8k-node
    bench mesh (scripts/profile_sweep.py reports the host_io_s it costs)."""
    u = u_base[None] * u_factors[:, None, None]
    f = f_base[None] * f_factors[:, None, None]
    return u, f


@jax.jit
def _perm_nodes(x, perm):
    """Device-side node permutation of a [B, N, 2] lane batch.

    The renumbering gather runs on device (~0.5 ms at 4096 lanes) instead
    of as host numpy fancy-indexing of the ~100 MB batch (~1 s, measured),
    and the un-permuted solution stays a device array -- callers that only
    read residuals/stresses never pay a device->host fetch of u."""
    return x[:, perm, :]


def _perm_arrays(perm, device_mesh):
    """(perm_dev, iperm_dev) device index arrays for _perm_nodes, or
    (None, None). iperm inverts perm: iperm[perm[i]] = i, so
    u_orig = u_renumbered[:, iperm, :]."""
    if perm is None:
        return None, None
    perm = np.asarray(perm)
    iperm = np.empty_like(perm)
    iperm[perm] = np.arange(perm.shape[0], dtype=perm.dtype)
    pd, id_ = jnp.asarray(perm), jnp.asarray(iperm)
    if device_mesh is not None:
        pd, id_ = _replicate_tree(device_mesh, (pd, id_))
    return pd, id_


def _chunked_lane_vm(u, tris, b_mat, sigma_fn, chunk: int = 512):
    """Per-lane von Mises WITHOUT materializing the full [E, 6, B] gather.

    u [2, N, B]; sigma_fn(strain [C, 3, B]) -> (s0, s1, s2) per-lane
    stress components. lax.map over element chunks bounds the transient at
    [C, 6, B] (~50-100 MB) -- the one-shot einsum at 24k elements x 4096
    lanes allocated a ~12 GB intermediate."""
    e_count = tris.shape[0]
    pad = (-e_count) % chunk
    if pad:
        tris = jnp.concatenate(
            [tris, jnp.zeros((pad, 3), dtype=tris.dtype)]
        )
        b_mat = jnp.concatenate(
            [b_mat, jnp.zeros((pad,) + b_mat.shape[1:], dtype=b_mat.dtype)]
        )
    g = tris.shape[0] // chunk

    def body(args):
        t_c, b_c = args
        ue = u[:, t_c, :]  # [2, C, 3, B]
        ue = ue.transpose(1, 2, 0, 3).reshape(chunk, 6, -1)
        strain = jnp.einsum(
            "erj,ejb->erb", b_c.astype(u.dtype), ue, precision="highest"
        )
        s0, s1, s2 = sigma_fn(strain)
        return jnp.sqrt(s0 * s0 - s0 * s1 + s1 * s1 + 3.0 * s2 * s2)

    vm = jax.lax.map(
        body,
        (
            tris.reshape(g, chunk, 3),
            b_mat.reshape((g, chunk) + b_mat.shape[1:]),
        ),
    )
    return vm.reshape(g * chunk, -1)[:e_count]


def lane_dia_matvec(bands, offsets: tuple, u):
    """y = K u on lane fields: bands [D, 2, 2, N], u [2, N, B] (lanes
    minormost, so every roll is a contiguous shift of whole lane rows).

    One roll per offset plus explicit 2x2 block FMAs, which XLA fuses
    into one pass over the lane field (an einsum would be a separate
    contraction per offset)."""
    y0 = jnp.zeros_like(u[0])
    y1 = jnp.zeros_like(u[1])
    for d_idx, off in enumerate(offsets):
        shifted = jnp.roll(u, -off, axis=1) if off != 0 else u
        b = bands[d_idx][:, :, :, None]  # [2,2,N,1] broadcast over lanes
        y0 = y0 + b[0, 0] * shifted[0] + b[0, 1] * shifted[1]
        y1 = y1 + b[1, 0] * shifted[0] + b[1, 1] * shifted[1]
    return jnp.stack([y0, y1])


def _lanes_core(
    bands,
    offsets: tuple,
    d_mat,
    b_mat,
    free,  # [2, N]
    u_fixed,  # [2, N, B]
    f_applied,  # [2, N, B]
    k_scales,  # [B]
    tris,
    iterations: int,
):
    """Batched solve with batch as the lane dimension."""
    # lane layout transform on device ([B,N,2] -> [2,N,B]); a host-side
    # numpy transpose of 4096 cases costs a >100 MB copy per call
    u_fixed = u_fixed.transpose(2, 1, 0)
    f_applied = f_applied.transpose(2, 1, 0)
    free_b = free[:, :, None]  # broadcast over lanes

    def base_matvec(u):  # u [2, N, B]
        return lane_dia_matvec(bands, offsets, u) * k_scales  # K_b = s_b*K

    def op(v):
        return free_b * base_matvec(free_b * v) + (1.0 - free_b) * v

    # block-Jacobi inverse of the scaled reduced diagonal
    zero_idx = offsets.index(0)
    diag = bands[zero_idx]  # [2, 2, N]
    f0, f1 = free[0], free[1]
    outer = free[:, None, :] * free[None, :, :]
    d = diag * outer
    d = d.at[0, 0].add(1.0 - f0)
    d = d.at[1, 1].add(1.0 - f1)
    a_, b_ = d[0, 0], d[0, 1]
    c_, e_ = d[1, 0], d[1, 1]
    det = a_ * e_ - b_ * c_
    det = jnp.where(det == 0, 1.0, det)
    inv = jnp.stack([jnp.stack([e_, -b_]), jnp.stack([-c_, a_])]) / det

    # un-scale: M_b^{-1} = (1/s_b) M^{-1}, except fixed DOFs (identity rows)
    inv_scale = free_b / k_scales + (1.0 - free_b)

    inv_b = inv[:, :, :, None]  # [2,2,N,1]

    def precond(r):
        p0 = inv_b[0, 0] * r[0] + inv_b[0, 1] * r[1]
        p1 = inv_b[1, 0] * r[0] + inv_b[1, 1] * r[1]
        return jnp.stack([p0, p1]) * inv_scale

    rhs = free_b * (f_applied - base_matvec(u_fixed)) + (1.0 - free_b) * u_fixed

    result = pcg_fixed_iterations(
        op,
        rhs,
        preconditioner=precond,
        x0=u_fixed,
        iterations=iterations,
        dot=_lane_dot,
    )
    u = result.x  # [2, N, B]

    # stress per lane: sigma = s_b * D B u_b (chunked -- the one-shot
    # [E, 6, B] gather OOMs at sweep scale)
    ks = k_scales[None, :]

    def sigma_fn(strain):
        sig = jnp.einsum("rs,esb->erb", d_mat, strain, precision="highest")
        return sig[:, 0] * ks, sig[:, 1] * ks, sig[:, 2] * ks

    vm = _chunked_lane_vm(u, tris, b_mat, sigma_fn)
    return (
        u.transpose(2, 1, 0),  # [B, N, 2]
        result.residual_norm,  # [B]
        vm.T,  # [B, E]
        jnp.sqrt(_lane_dot(rhs, rhs)),  # [B]
    )


@partial(jax.jit, static_argnames=("offsets", "iterations"))
def _lanes_jit(bands, offsets, d_mat, b_mat, free, u_fixed, f_applied,
               k_scales, tris, iterations):
    return _lanes_core(
        bands, offsets, d_mat, b_mat, free, u_fixed, f_applied, k_scales,
        tris, iterations,
    )


def _sweep_lanes(
    mesh, base_bca, metadata, u_values, f_values, k_scales, iterations, dtype,
    dia,
):
    from ..fem.element import (
        element_areas,
        gather_element_coords,
        strain_displacement_matrices,
        stress_strain_matrix,
    )

    n = mesh.num_nodes
    coords = jnp.asarray(mesh.coords, dtype=dtype)
    tris = jnp.asarray(mesh.tris)
    ke = element_stiffness_matrices(
        coords,
        tris,
        metadata.youngs_modulus,
        metadata.poisson_ratio,
        metadata.part_thickness,
    )
    bands = assemble_dia(ke, dia.slot_ids, n, dia.n_diags)
    offsets = tuple(int(o) for o in dia.offsets)

    ecoords = gather_element_coords(coords, tris)
    areas = element_areas(ecoords)
    b_mat = strain_displacement_matrices(ecoords, areas)  # [E,3,6]
    d_mat = stress_strain_matrix(
        metadata.youngs_modulus, metadata.poisson_ratio, dtype=dtype
    )

    free = jnp.asarray((~base_bca.u_known).T.astype(dtype))  # [2, N]
    u, res, vm, rhs_norm = _lanes_jit(
        bands,
        offsets,
        d_mat,
        b_mat,
        free,
        jnp.asarray(u_values, dtype=dtype),  # [B, N, 2]
        jnp.asarray(f_values, dtype=dtype),
        jnp.asarray(k_scales, dtype=dtype),
        tris,
        int(iterations),
    )
    return SweepResult(u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm)


# -------------------------- stencil+MG lanes path --------------------------


def _lane_stencil_matvec(stencil, u, wrap: bool):
    """y = K u for all lanes: stencil [9,2,2,R,C], u [2,R,C,B].

    ONE padded copy of u, then each of the nine neighbor accesses is a pure
    static slice -- slices fuse into the FMA consumers, where a roll-based
    shift would materialize a full shifted copy per offset (9x the HBM
    writes at 4096 lanes).
    """
    from ..fem.stencil import OFFSETS

    rows, cols = u.shape[-3], u.shape[-2]
    if wrap:
        # periodic cols: edge columns wrap; rows zero-pad
        u_pad = jnp.concatenate(
            [u[..., -1:, :], u, u[..., :1, :]], axis=-2
        )
        u_pad = jnp.pad(u_pad, ((0, 0), (1, 1), (0, 0), (0, 0)))
    else:
        u_pad = jnp.pad(u, ((0, 0), (1, 1), (1, 1), (0, 0)))

    y0 = jnp.zeros_like(u[0])
    y1 = jnp.zeros_like(u[1])
    for s, (dr, dt) in enumerate(OFFSETS):
        us = jax.lax.slice(
            u_pad,
            (0, 1 + dr, 1 + dt, 0),
            (2, 1 + dr + rows, 1 + dt + cols, u.shape[-1]),
        )
        blk = stencil[s][..., None]  # [2,2,R,C,1] broadcast over lanes
        y0 = y0 + blk[0, 0] * us[0] + blk[0, 1] * us[1]
        y1 = y1 + blk[1, 0] * us[0] + blk[1, 1] * us[1]
    return jnp.stack([y0, y1])


def _lane_prolong(uc, wrap: bool):
    """Bilinear coarse -> fine on [..., Rc, Cc, B] (lane-batched
    fem/multigrid.prolong: col axis -2, row axis -3)."""
    if wrap:
        mid = 0.5 * (uc + jnp.roll(uc, -1, axis=-2))
        x = jnp.stack([uc, mid], axis=-2)
        x = x.reshape(*uc.shape[:-2], -1, uc.shape[-1])
    else:
        a = uc[..., :-1, :]
        mid = 0.5 * (uc[..., :-1, :] + uc[..., 1:, :])
        body = jnp.stack([a, mid], axis=-2).reshape(
            *uc.shape[:-3], uc.shape[-3], -1, uc.shape[-1]
        )
        x = jnp.concatenate([body, uc[..., -1:, :]], axis=-2)
    a = x[..., :-1, :, :]
    mid = 0.5 * (x[..., :-1, :, :] + x[..., 1:, :, :])
    body = jnp.stack([a, mid], axis=-3).reshape(
        *x.shape[:-3], -1, x.shape[-2], x.shape[-1]
    )
    return jnp.concatenate([body, x[..., -1:, :, :]], axis=-3)


def _lane_restrict(rf, wrap: bool):
    """Adjoint of _lane_prolong, fine -> coarse on [..., R, C, B]."""
    even = rf[..., ::2, :, :]
    odd = rf[..., 1::2, :, :]
    pad_top = [(0, 0)] * (odd.ndim - 3) + [(1, 0), (0, 0), (0, 0)]
    pad_bot = [(0, 0)] * (odd.ndim - 3) + [(0, 1), (0, 0), (0, 0)]
    up = jnp.pad(odd, pad_top)[..., : even.shape[-3], :, :]
    down = jnp.pad(odd, pad_bot)[..., : even.shape[-3], :, :]
    x = even + 0.5 * (up + down)
    even = x[..., ::2, :]
    odd = x[..., 1::2, :]
    if wrap:
        left = jnp.roll(odd, 1, axis=-2)
        return even + 0.5 * (odd + left)
    pad_l = [(0, 0)] * (odd.ndim - 2) + [(1, 0), (0, 0)]
    pad_r = [(0, 0)] * (odd.ndim - 2) + [(0, 1), (0, 0)]
    up = jnp.pad(odd, pad_l)[..., : even.shape[-2], :]
    down = jnp.pad(odd, pad_r)[..., : even.shape[-2], :]
    return even + 0.5 * (up + down)


def _lane_dinv(diag_inv, r):
    d = diag_inv[..., None]  # [2,2,R,C,1]
    return jnp.stack(
        [d[0, 0] * r[0] + d[0, 1] * r[1], d[1, 0] * r[0] + d[1, 1] * r[1]]
    )


def _lane_dense_coarse(dense_inv, r):
    """Exact coarse solve for all lanes at once: one dense matmul
    [2RC, 2RC] x [2RC, B] (node-major flattening)."""
    two, rows, cols, b = r.shape
    r_flat = r.transpose(1, 2, 0, 3).reshape(rows * cols * 2, b)
    e = jnp.matmul(dense_inv, r_flat, precision="highest")
    return e.reshape(rows, cols, 2, b).transpose(2, 0, 1, 3)


def _lane_vcycle(levels, wrap, pre=2, post=2, coarse_sweeps=48, omega=0.7):
    """V-cycle over lane-batched fields sharing ONE hierarchy: the variants
    differ only by the scale s_b, and V(s_b K) = (1/s_b) V(K) exactly.
    The coarsest level solves exactly via the hierarchy's dense inverse
    (one matmul over all lanes) when available."""

    def smooth(level, e, r, sweeps):
        for _ in range(sweeps):
            res = r - _lane_stencil_matvec(level.stencil, e, wrap)
            e = e + omega * _lane_dinv(level.diag_inv, res)
        return e

    def cycle(l, r):
        level = levels[l]
        zero = jnp.zeros_like(r)
        if l == len(levels) - 1:
            if level.dense_inv is not None:
                return _lane_dense_coarse(level.dense_inv, r)
            return smooth(level, zero, r, coarse_sweeps)
        e = smooth(level, zero, r, pre)
        res = r - _lane_stencil_matvec(level.stencil, e, wrap)
        ec = cycle(l + 1, _lane_restrict(res, wrap))
        e = e + _lane_prolong(ec, wrap)
        return smooth(level, e, r, post)

    return lambda r: cycle(0, r)


def _lane_grid_dot(a, b):
    """Per-lane inner product on [2, R, C, B] -> [B]."""
    return jnp.sum(a * b, axis=(0, 1, 2))


class _LaneLevel(NamedTuple):
    """Array-only multigrid level (pytree-safe across jit boundaries)."""

    stencil: jax.Array
    diag_inv: jax.Array
    dense_inv: jax.Array = None


@partial(jax.jit, static_argnames=("rows", "cols", "wrap"))
def _stencil_sweep_setup(coords, tris, free_g, e_mod, nu, t, rows, cols, wrap):
    """One-time per-mesh work: assembly, BC reduction, multigrid hierarchy,
    stress-recovery matrices. Returned as plain arrays so the per-batch
    solve jit can consume them without redoing any of it."""
    from ..fem.element import (
        element_areas,
        gather_element_coords,
        strain_displacement_matrices,
        stress_strain_matrix,
    )
    from ..fem.solve import _reduce_stencil
    from ..fem.multigrid import build_hierarchy
    from ..fem.stencil import assemble_stencil_structured

    raw = assemble_stencil_structured(coords, e_mod, nu, t, rows, cols, wrap)
    reduced = _reduce_stencil(raw, free_g, wrap)
    levels = tuple(
        _LaneLevel(lv.stencil, lv.diag_inv, lv.dense_inv)
        for lv in build_hierarchy(reduced, free_g, wrap)
    )
    ecoords = gather_element_coords(coords, tris)
    areas = element_areas(ecoords)
    b_mat = strain_displacement_matrices(ecoords, areas)
    d_mat = stress_strain_matrix(e_mod, nu, dtype=coords.dtype)
    return raw, reduced, levels, b_mat, d_mat


@partial(jax.jit, static_argnames=("rows", "cols", "wrap", "iterations"))
def _stencil_lanes_jit(
    setup, tris, free_g, u_values, f_values, k_scales,
    rows, cols, wrap, iterations,
):
    raw, reduced, levels, b_mat, d_mat = setup

    # lane layout transform on device ([B,N,2] -> [2,R,C,B]); doing this on
    # host costs a 140 MB numpy transpose + copy per call
    b = u_values.shape[0]
    u_fixed = u_values.transpose(2, 1, 0).reshape(2, rows, cols, b)
    f_applied = f_values.transpose(2, 1, 0).reshape(2, rows, cols, b)

    free_b = free_g[..., None]  # [2, R, C, 1]
    inv_scale = free_b / k_scales + (1.0 - free_b)

    def op(v):  # lanes of s_b * K_reduced
        y = _lane_stencil_matvec(reduced, v, wrap)
        return free_b * y * k_scales + (1.0 - free_b) * v

    vcycle = _lane_vcycle(levels, wrap)

    def precond(r):  # V(s_b K)^-1 = (1/s_b) V(K)^-1, identity on fixed DOFs
        return vcycle(r) * inv_scale

    raw_mv = lambda v: _lane_stencil_matvec(raw, v, wrap)
    rhs = free_b * (f_applied - raw_mv(u_fixed) * k_scales) + (
        1.0 - free_b
    ) * u_fixed

    result = pcg_fixed_iterations(
        op,
        rhs,
        preconditioner=precond,
        x0=u_fixed,
        iterations=iterations,
        dot=_lane_grid_dot,
    )
    # recompute the TRUE residual (CG's recursive residual drifts below the
    # f32 floor and would over-report convergence)
    res_true = rhs - op(result.x)
    res_norm = jnp.sqrt(_lane_grid_dot(res_true, res_true))

    # stress recovery per lane: sigma = s_b * D B u_b
    u_flat = result.x.reshape(2, rows * cols, b)
    ue = u_flat[:, tris, :]  # [2, E, 3, B]
    ue = ue.transpose(1, 2, 0, 3).reshape(tris.shape[0], 6, -1)
    strain = jnp.einsum("erj,ejb->erb", b_mat, ue, precision="highest")
    sigma = jnp.einsum("rs,esb->erb", d_mat, strain, precision="highest")
    vm = (
        jnp.sqrt(
            sigma[:, 0] ** 2
            - sigma[:, 0] * sigma[:, 1]
            + sigma[:, 1] ** 2
            + 3.0 * sigma[:, 2] ** 2
        )
        * k_scales[None, :]
    )
    return (
        u_flat.transpose(2, 1, 0),
        res_norm,
        vm.T,
        jnp.sqrt(_lane_grid_dot(rhs, rhs)),
    )


@dataclass
class CompiledSweep:
    """A mesh compiled for repeated design-sweep batches.

    Setup (assembly, BC reduction, multigrid hierarchy incl. the dense
    coarse inverse, stress matrices) runs once and stays device-resident;
    `solve(u_values, f_values, k_scales)` only pays the batched CG -- the
    serving pattern for interactive design exploration."""

    setup: tuple
    tris: jax.Array
    free_g: jax.Array
    rows: int
    cols: int
    wrap: bool
    iterations: int
    dtype: object
    # lanes shard over this jax.sharding.Mesh (None = single device)
    device_mesh: object = None

    def _batch(self, arr):
        if self.device_mesh is not None:
            return _shard_lanes(self.device_mesh, arr, self.dtype)
        return jnp.asarray(arr, dtype=self.dtype)

    def solve(self, u_values, f_values, k_scales) -> SweepResult:
        u, res, vm, rhs_norm = _stencil_lanes_jit(
            self.setup,
            self.tris,
            self.free_g,
            self._batch(u_values),
            self._batch(f_values),
            self._batch(k_scales),
            self.rows,
            self.cols,
            self.wrap,
            self.iterations,
        )
        return SweepResult(
            u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm
        )


def compile_sweep(
    mesh, base_bca, metadata, iterations: int = 20, dtype=np.float32,
    device_mesh=None,
) -> CompiledSweep:
    """Build a CompiledSweep for a coarsenable canonical-grid mesh.

    `device_mesh`: a jax.sharding.Mesh to shard the LANE axis over (pure
    data parallelism -- each device solves its slice of the variants with
    the shared replicated hierarchy; no collectives in the solve)."""
    from ..utils.jaxcache import ensure_default_cache

    ensure_default_cache()
    from ..fem.multigrid import can_coarsen
    from ..fem.solve import _grid

    if mesh.grid_shape is None or not mesh.canonical_grid:
        raise ValueError("compile_sweep needs a canonical grid mesh")
    rows, cols = mesh.grid_shape
    if not can_coarsen(rows, cols, mesh.wrap_cols):
        raise ValueError("grid cannot coarsen; use sweep_solve's DIA path")
    wrap = mesh.wrap_cols
    coords = jnp.asarray(mesh.coords, dtype=dtype)
    tris = jnp.asarray(mesh.tris)
    free_g = _grid(jnp.asarray(~base_bca.u_known, dtype=dtype), rows, cols)
    setup = _stencil_sweep_setup(
        coords,
        tris,
        free_g,
        jnp.asarray(metadata.youngs_modulus, dtype=dtype),
        jnp.asarray(metadata.poisson_ratio, dtype=dtype),
        jnp.asarray(metadata.part_thickness, dtype=dtype),
        rows,
        cols,
        wrap,
    )
    if device_mesh is not None:
        setup, tris, free_g = _replicate_tree(
            device_mesh, (setup, tris, free_g)
        )
    return CompiledSweep(
        setup=jax.block_until_ready(setup),
        tris=tris,
        free_g=free_g,
        rows=rows,
        cols=cols,
        wrap=wrap,
        iterations=int(iterations),
        dtype=dtype,
        device_mesh=device_mesh,
    )


def _sweep_stencil_lanes(
    mesh, base_bca, metadata, u_values, f_values, k_scales, iterations, dtype
):
    """Lane-batched sweep on the stencil operator with a SHARED multigrid
    hierarchy: one V-cycle preconditions all 4096 variants at once, so the
    fixed iteration budget drops from hundreds (block-Jacobi) to ~15."""
    compiled = compile_sweep(mesh, base_bca, metadata, iterations, dtype)
    return compiled.solve(u_values, f_values, k_scales)


# ------------------------------ vmap path ---------------------------------


def _single_solve(
    ell, cols, diag, free, u_fixed, f_applied, k_scale, iterations
):
    """One lane of the vmap sweep: solve (k_scale*K) u = f with BCs."""
    ell_s = ell * k_scale
    diag_s = diag * k_scale
    matvec = make_ell_operator(ell_s, cols)
    op = make_constrained_operator(matvec, free)
    precond = block_jacobi_preconditioner(diag_s, free)
    b = reduced_rhs(matvec, free, u_fixed, f_applied)
    result = pcg_fixed_iterations(
        op, b, preconditioner=precond, x0=u_fixed, iterations=iterations
    )
    return result.x, result.residual_norm, jnp.sqrt(jnp.sum(b * b))


def _sweep_vmap(
    mesh, base_bca, metadata, u_values, f_values, k_scales, iterations, dtype,
    structure,
):
    n = mesh.num_nodes
    if structure is None:
        structure = build_ell_structure(mesh.tris, n)

    coords = jnp.asarray(mesh.coords, dtype=dtype)
    tris = jnp.asarray(mesh.tris)
    free = jnp.asarray((~base_bca.u_known), dtype=dtype)

    @partial(jax.jit, static_argnums=(2, 3))
    def run(batch, operands, n_nodes, width):
        coords, tris, slot_ids, cols, free = operands
        ke = element_stiffness_matrices(
            coords,
            tris,
            metadata.youngs_modulus,
            metadata.poisson_ratio,
            metadata.part_thickness,
        )
        ell = assemble_ell_arrays(ke, slot_ids, n_nodes, width)
        own = (
            jnp.arange(n_nodes, dtype=cols.dtype)[:, None] == cols
        ).astype(ell.dtype)
        diag = jnp.einsum("nk,nkij->nij", own, ell, precision="highest")

        def lane(u_fixed, f_applied, k_scale):
            u, res, bn = _single_solve(
                ell, cols, diag, free, u_fixed, f_applied, k_scale, iterations
            )
            sigma = element_stress_tensors(
                coords,
                tris,
                u,
                metadata.youngs_modulus,
                metadata.poisson_ratio,
            )
            vm = von_mises_stress(sigma) * k_scale
            return u, res, vm, bn

        return jax.vmap(lane)(*batch)

    u, res, vm, rhs_norm = run(
        (
            jnp.asarray(u_values, dtype=dtype),
            jnp.asarray(f_values, dtype=dtype),
            jnp.asarray(k_scales, dtype=dtype),
        ),
        (
            coords,
            tris,
            jnp.asarray(structure.slot_ids),
            jnp.asarray(structure.cols),
            free,
        ),
        n,
        structure.width,
    )
    return SweepResult(u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm)


# ------------------------------ public API --------------------------------


def _amg_sweep_min_nodes() -> int:
    """Auto-dispatch threshold for AMG lanes, shared with the solver's
    AMG auto-engage rule (config.SolverOptions.amg_auto_min_nodes)."""
    from ..config import SolverOptions

    return int(SolverOptions().amg_auto_min_nodes)


def sweep_solve(
    mesh: Mesh,
    base_bca: BCArrays,
    metadata: ModelMetadata,
    u_values: np.ndarray,  # [B, N, 2] prescribed displacement per variant
    f_values: np.ndarray,  # [B, N, 2] applied force per variant
    k_scales: np.ndarray,  # [B] Young's-modulus scale per variant
    iterations: int = 200,
    dtype=np.float32,
    structure=None,
    impl: str = "auto",
) -> SweepResult:
    """Batched solve over B variants sharing one sparsity + base operator.

    The constraint PATTERN (which DOFs are fixed) is shared across variants;
    values and stiffness scale vary. Returns per-variant displacement and
    von Mises fields. k_scales model Young's modulus at fixed Poisson ratio
    and thickness (u scales as 1/s for force-driven cases; stress recovery
    accounts for the material scale in both cases).

    impl: "auto" | "stencil" (grid + shared multigrid) | "amg"
    (arbitrary meshes, shared AMG hierarchy -- compile_unstructured_sweep)
    | "lanes" (DIA block-Jacobi) | vmap fallback. Auto routes unstructured
    meshes at AMG scale through the AMG lanes with a capped iteration
    budget (~25 suffice at ~1e-6; each costs ~5 block-Jacobi iterations).
    """
    if impl in ("auto", "stencil") and mesh.grid_shape is not None:
        from ..fem.multigrid import can_coarsen
        from ..fem.stencil import build_stencil_structure

        rows, cols = mesh.grid_shape
        grid_ok = mesh.grid_local or (
            build_stencil_structure(mesh.tris, rows, cols, mesh.wrap_cols)
            is not None
        )
        if (
            grid_ok
            and mesh.canonical_grid
            and can_coarsen(rows, cols, mesh.wrap_cols)
        ):
            return _sweep_stencil_lanes(
                mesh, base_bca, metadata, u_values, f_values, k_scales,
                iterations, dtype,
            )
        if impl == "stencil":
            raise ValueError(
                "mesh is not a coarsenable canonical grid; stencil sweep "
                "unavailable"
            )
    elif impl == "stencil":
        raise ValueError(
            "mesh has no grid_shape; stencil sweep unavailable"
        )
    if impl == "amg" or (
        impl == "auto"
        and mesh.grid_shape is None
        and mesh.num_nodes >= _amg_sweep_min_nodes()
    ):
        # arbitrary meshes at scale: block-Jacobi lockstep iteration counts
        # grow O(1/h); the shared-AMG lanes stay mesh-independent. In auto
        # mode the fixed budget is capped (each AMG iteration costs ~5
        # block-Jacobi ones and ~25 suffice for ~1e-6). impl='amg' runs the
        # caller's budget verbatim.
        amg_iters = (
            iterations if impl == "amg" else min(int(iterations), 40)
        )
        if amg_iters != iterations:
            from ..utils.logging import log

            log(
                "info: sweep auto-selected AMG lanes; translating the "
                f"iteration budget {iterations} -> {amg_iters} AMG "
                "iterations (pass impl='amg' to run the budget verbatim; "
                "check result.residual_norm for per-lane quality)"
            )
        # Auto must not OOM where the old f32 block-Jacobi lanes fit:
        # refined mode (f64 CG over the f32 V-cycle, the default under
        # x64) DOUBLES the [2, N, B] lane-state footprint. Estimate it
        # (~8 live state vectors) against the device's memory and drop
        # to f32 CG when it would not fit; explicit impl='amg' keeps the
        # library default (pass refined= to compile_unstructured_sweep
        # for full control).
        refined = None
        if impl == "auto" and dtype == np.float32:
            b_lanes = int(np.asarray(u_values).shape[0])
            est_f64 = 8 * 2 * mesh.num_nodes * max(b_lanes, 1) * 8
            budget = None
            try:
                stats = jax.devices()[0].memory_stats()
                budget = (stats or {}).get("bytes_limit")
            except Exception:
                pass
            if budget and est_f64 > 0.6 * int(budget):
                refined = False
                from ..utils.logging import log

                log(
                    "info: sweep AMG lanes: f64 refined CG state "
                    f"(~{est_f64 / 1e9:.1f} GB for {b_lanes} lanes) "
                    "exceeds the device memory budget; running f32 CG "
                    "(residuals floor near the f32 wall ~6e-6 relative)"
                )
        try:
            compiled = compile_unstructured_sweep(
                mesh, base_bca, metadata, amg_iters, dtype, refined=refined
            )
            return compiled.solve(u_values, f_values, k_scales)
        except ValueError:
            if impl == "amg":
                raise
    if impl in ("auto", "lanes"):
        dia = build_dia_structure(mesh.tris, mesh.num_nodes)
        if dia is not None:
            return _sweep_lanes(
                mesh, base_bca, metadata, u_values, f_values, k_scales,
                iterations, dtype, dia,
            )
        if impl == "lanes":
            raise ValueError("mesh is not DIA-compatible; lanes sweep unavailable")
    return _sweep_vmap(
        mesh, base_bca, metadata, u_values, f_values, k_scales,
        iterations, dtype, structure,
    )


# ------------------- material-sweep (E, nu, t) lanes ------------------------
#
# True material sweeps: Young's modulus, Poisson ratio AND thickness vary
# per lane. The plane-stress D matrix is a linear combination
#     D(E, nu) = d0*Da + d1*Db + d2*Dc,
#     d0 = E/(1-nu^2), d1 = nu*d0, d2 = (1-nu)/2*d0,
# and the assembled stiffness is linear in (d0, d1, d2) and in t, so THREE
# basis stencils (unit d0 / d1 / d2, t=1) assembled once span every material:
#     K(E, nu, t) = wa*Ka + wb*Kb + wc*Kc,
#     wa = t*E/(1-nu^2), wb = wa*nu, wc = wa*(1-nu)/2.
# Galerkin coarsening is linear in the operator too, so the multigrid
# hierarchy carries the basis decomposition down every level -- one
# 4-stencil hierarchy (3 material bases + the fixed-DOF identity part)
# preconditions all lanes with their EXACT per-lane coarse operators.


class _MaterialLevel(NamedTuple):
    """One hierarchy level: masked material bases + fixed-DOF identity."""

    sa: jax.Array  # [9,2,2,R,C]
    sb: jax.Array
    sc: jax.Array
    sfix: jax.Array


def material_weights(e_moduli, poisson_ratios, thicknesses):
    """Per-lane basis weights (wa, wb, wc), each [B]."""
    wa = thicknesses * e_moduli / (1.0 - poisson_ratios * poisson_ratios)
    return wa, wa * poisson_ratios, wa * (1.0 - poisson_ratios) / 2.0


def _mask_stencil(raw, free_g, wrap):
    """BC mask WITHOUT the fixed-DOF identity (that part is lane-invariant
    and lives in its own basis stencil so lane scaling stays exact)."""
    from ..fem.stencil import OFFSETS, shift2d

    out = []
    for s, (dr, dt) in enumerate(OFFSETS):
        fin = shift2d(free_g, dr, dt, wrap)
        out.append(raw[s] * free_g[:, None] * fin[None, :])
    return jnp.stack(out)


def _fixed_identity_stencil(free_g):
    from ..fem.stencil import CENTER

    two, rows, cols = free_g.shape
    sfix = jnp.zeros((9, 2, 2, rows, cols), dtype=free_g.dtype)
    sfix = sfix.at[CENTER, 0, 0].set(1.0 - free_g[0])
    sfix = sfix.at[CENTER, 1, 1].set(1.0 - free_g[1])
    return sfix


@partial(jax.jit, static_argnames=("rows", "cols", "wrap"))
def _material_sweep_setup(coords, tris, free_g, rows, cols, wrap):
    """One-time per-mesh work: 3 raw + 4 masked basis stencils, the
    4-stencil Galerkin hierarchy, and stress-recovery matrices."""
    from ..fem.element import (
        element_areas,
        gather_element_coords,
        strain_displacement_matrices,
    )
    from ..fem.multigrid import can_coarsen, galerkin_coarse_stencil
    from ..fem.stencil import assemble_stencil_structured, make_stencil_operator

    basis_raw = tuple(
        assemble_stencil_structured(
            coords, 0.0, 0.0, 1.0, rows, cols, wrap, dcoefs=dc
        )
        for dc in ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))
    )
    level0 = _MaterialLevel(
        *(_mask_stencil(raw, free_g, wrap) for raw in basis_raw),
        _fixed_identity_stencil(free_g),
    )
    levels = [level0]
    r, c = rows, cols
    while can_coarsen(r, c, wrap):
        rc = (r - 1) // 2 + 1
        cc = c // 2 if wrap else (c - 1) // 2 + 1
        prev = levels[-1]
        coarse = _MaterialLevel(
            *(
                galerkin_coarse_stencil(
                    make_stencil_operator(st, wrap),
                    rc,
                    cc,
                    wrap,
                    coords.dtype,
                )
                for st in prev
            )
        )
        levels.append(coarse)
        r, c = rc, cc

    ecoords = gather_element_coords(coords, tris)
    areas = element_areas(ecoords)
    b_mat = strain_displacement_matrices(ecoords, areas)
    return basis_raw, tuple(levels), b_mat


def _lane_material_matvec(level: _MaterialLevel, wa, wb, wc, u, wrap):
    """Per-lane y = K(w) u on [2, R, C, B] lane fields: pad u once, combine
    the basis blocks per offset with the lane weights (XLA fuses the
    combination into the FMA chain; no per-lane stencil is materialized)."""
    from ..fem.stencil import OFFSETS

    rows, cols = u.shape[-3], u.shape[-2]
    if wrap:
        u_pad = jnp.concatenate([u[..., -1:, :], u, u[..., :1, :]], axis=-2)
        u_pad = jnp.pad(u_pad, ((0, 0), (1, 1), (0, 0), (0, 0)))
    else:
        u_pad = jnp.pad(u, ((0, 0), (1, 1), (1, 1), (0, 0)))

    sa, sb, sc, sfix = level
    y0 = jnp.zeros_like(u[0])
    y1 = jnp.zeros_like(u[1])
    for s, (dr, dt) in enumerate(OFFSETS):
        us = jax.lax.slice(
            u_pad,
            (0, 1 + dr, 1 + dt, 0),
            (2, 1 + dr + rows, 1 + dt + cols, u.shape[-1]),
        )

        def coef(i, j):
            return (
                sa[s, i, j][..., None] * wa
                + sb[s, i, j][..., None] * wb
                + sc[s, i, j][..., None] * wc
                + sfix[s, i, j][..., None]
            )

        y0 = y0 + coef(0, 0) * us[0] + coef(0, 1) * us[1]
        y1 = y1 + coef(1, 0) * us[0] + coef(1, 1) * us[1]
    return jnp.stack([y0, y1])


def _lane_material_center_inv(level: _MaterialLevel, wa, wb, wc):
    """Per-lane inverse center blocks [2,2,R,C,B] (precomputed per batch)."""
    from ..fem.stencil import CENTER

    def comb(i, j):
        return (
            level.sa[CENTER, i, j][..., None] * wa
            + level.sb[CENTER, i, j][..., None] * wb
            + level.sc[CENTER, i, j][..., None] * wc
            + level.sfix[CENTER, i, j][..., None]
        )

    a_, b_ = comb(0, 0), comb(0, 1)
    c_, e_ = comb(1, 0), comb(1, 1)
    det = a_ * e_ - b_ * c_
    det = jnp.where(det == 0, 1.0, det)
    return jnp.stack([jnp.stack([e_, -b_]), jnp.stack([-c_, a_])]) / det


def _lane_material_vcycle(
    levels, dinvs, wa, wb, wc, wrap, pre=2, post=2, coarse_sweeps=48,
    omega=0.7,
):
    """Lane-batched V-cycle with EXACT per-lane operators at every level
    (the basis decomposition survives Galerkin coarsening)."""

    def smooth(l, e, r, sweeps):
        for _ in range(sweeps):
            res = r - _lane_material_matvec(levels[l], wa, wb, wc, e, wrap)
            e = e + omega * _lane_dinv_b(dinvs[l], res)
        return e

    def cycle(l, r):
        zero = jnp.zeros_like(r)
        if l == len(levels) - 1:
            return smooth(l, zero, r, coarse_sweeps)
        e = smooth(l, zero, r, pre)
        res = r - _lane_material_matvec(levels[l], wa, wb, wc, e, wrap)
        ec = cycle(l + 1, _lane_restrict(res, wrap))
        e = e + _lane_prolong(ec, wrap)
        return smooth(l, e, r, post)

    return lambda r: cycle(0, r)


def _lane_dinv_b(dinv, r):
    """Apply per-lane [2,2,R,C,B] inverse blocks to [2,R,C,B]."""
    return jnp.stack(
        [
            dinv[0, 0] * r[0] + dinv[0, 1] * r[1],
            dinv[1, 0] * r[0] + dinv[1, 1] * r[1],
        ]
    )


@partial(jax.jit, static_argnames=("rows", "cols", "wrap", "iterations"))
def _material_lanes_jit(
    setup, tris, free_g, u_values, f_values, e_moduli, poisson_ratios,
    thicknesses, rows, cols, wrap, iterations,
):
    basis_raw, levels, b_mat = setup
    wa, wb, wc = material_weights(e_moduli, poisson_ratios, thicknesses)

    b = u_values.shape[0]
    u_fixed = u_values.transpose(2, 1, 0).reshape(2, rows, cols, b)
    f_applied = f_values.transpose(2, 1, 0).reshape(2, rows, cols, b)
    free_b = free_g[..., None]

    # per-level per-lane center inverses, computed once per batch
    dinvs = tuple(
        _lane_material_center_inv(lv, wa, wb, wc) for lv in levels
    )

    def op(v):  # masked bases + fixed identity = the reduced operator
        return _lane_material_matvec(levels[0], wa, wb, wc, v, wrap)

    def raw_mv(v):
        ra, rb, rc_ = basis_raw
        ya = _lane_stencil_matvec(ra, v, wrap)
        yb = _lane_stencil_matvec(rb, v, wrap)
        yc = _lane_stencil_matvec(rc_, v, wrap)
        return ya * wa + yb * wb + yc * wc

    precond = _lane_material_vcycle(levels, dinvs, wa, wb, wc, wrap)

    rhs = free_b * (f_applied - raw_mv(u_fixed)) + (1.0 - free_b) * u_fixed

    result = pcg_fixed_iterations(
        op,
        rhs,
        preconditioner=precond,
        x0=u_fixed,
        iterations=iterations,
        dot=_lane_grid_dot,
    )
    res_true = rhs - op(result.x)
    res_norm = jnp.sqrt(_lane_grid_dot(res_true, res_true))

    # per-lane stress: sigma_l = D(E_l, nu_l) B u_l (thickness-free)
    d0 = e_moduli / (1.0 - poisson_ratios * poisson_ratios)
    d1 = d0 * poisson_ratios
    d2 = d0 * (1.0 - poisson_ratios) / 2.0
    u_flat = result.x.reshape(2, rows * cols, b)
    ue = u_flat[:, tris, :]
    ue = ue.transpose(1, 2, 0, 3).reshape(tris.shape[0], 6, -1)
    strain = jnp.einsum("erj,ejb->erb", b_mat, ue, precision="highest")
    s0 = d0 * strain[:, 0] + d1 * strain[:, 1]
    s1 = d1 * strain[:, 0] + d0 * strain[:, 1]
    s2 = d2 * strain[:, 2]
    vm = jnp.sqrt(s0**2 - s0 * s1 + s1**2 + 3.0 * s2**2)
    return (
        u_flat.transpose(2, 1, 0),
        res_norm,
        vm.T,
        jnp.sqrt(_lane_grid_dot(rhs, rhs)),
    )


@dataclass
class CompiledMaterialSweep:
    """A mesh compiled for repeated (E, nu, t) material-sweep batches."""

    setup: tuple
    tris: jax.Array
    free_g: jax.Array
    rows: int
    cols: int
    wrap: bool
    iterations: int
    dtype: object
    # lanes shard over this jax.sharding.Mesh (None = single device)
    device_mesh: object = None

    def _batch(self, arr):
        if self.device_mesh is not None:
            return _shard_lanes(self.device_mesh, arr, self.dtype)
        return jnp.asarray(arr, dtype=self.dtype)

    def solve(
        self, u_values, f_values, e_moduli, poisson_ratios, thicknesses
    ) -> SweepResult:
        u, res, vm, rhs_norm = _material_lanes_jit(
            self.setup,
            self.tris,
            self.free_g,
            self._batch(u_values),
            self._batch(f_values),
            self._batch(e_moduli),
            self._batch(poisson_ratios),
            self._batch(thicknesses),
            self.rows,
            self.cols,
            self.wrap,
            self.iterations,
        )
        return SweepResult(
            u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm
        )


def compile_material_sweep(
    mesh, base_bca, iterations: int = 30, dtype=np.float32, device_mesh=None
) -> CompiledMaterialSweep:
    """Compile a canonical-grid mesh for true material sweeps.

    Every lane gets its own (E, nu, t): three basis stencils are assembled
    once and combined per lane with scalar weights, and the multigrid
    hierarchy carries the decomposition down exactly. Memory note: the
    per-level per-lane center inverses are [2,2,R,C,B] -- at 4096 lanes on
    a 33x65 grid that is ~140 MB f32, shrinking 4x per level.
    """
    from ..utils.jaxcache import ensure_default_cache

    ensure_default_cache()
    from ..fem.solve import _grid

    if mesh.grid_shape is None or not mesh.canonical_grid:
        raise ValueError("compile_material_sweep needs a canonical grid mesh")
    rows, cols = mesh.grid_shape
    wrap = mesh.wrap_cols
    coords = jnp.asarray(mesh.coords, dtype=dtype)
    tris = jnp.asarray(mesh.tris)
    free_g = _grid(jnp.asarray(~base_bca.u_known, dtype=dtype), rows, cols)
    setup = _material_sweep_setup(coords, tris, free_g, rows, cols, wrap)
    if device_mesh is not None:
        setup, tris, free_g = _replicate_tree(
            device_mesh, (setup, tris, free_g)
        )
    return CompiledMaterialSweep(
        setup=jax.block_until_ready(setup),
        tris=tris,
        free_g=free_g,
        rows=rows,
        cols=cols,
        wrap=wrap,
        iterations=int(iterations),
        dtype=dtype,
        device_mesh=device_mesh,
    )


def material_sweep_solve(
    mesh: Mesh,
    base_bca: BCArrays,
    u_values: np.ndarray,  # [B, N, 2]
    f_values: np.ndarray,  # [B, N, 2]
    e_moduli: np.ndarray,  # [B] Young's modulus per variant
    poisson_ratios: np.ndarray,  # [B]
    thicknesses: np.ndarray,  # [B]
    iterations: int = 30,
    dtype=np.float32,
) -> SweepResult:
    """One-shot material sweep (see compile_material_sweep for serving)."""
    compiled = compile_material_sweep(mesh, base_bca, iterations, dtype)
    return compiled.solve(
        u_values, f_values, e_moduli, poisson_ratios, thicknesses
    )


# --------------- unstructured AMG lanes (shared hierarchy) ------------------


def _banded_mesh_or_raise(mesh, base_bca, max_diags: int, fallback_hint: str):
    """Band structure for an arbitrary mesh, renumbering when needed.

    Returns (mesh, bca, dia, perm); raises ValueError (with the caller's
    suggested fallback) when the mesh stays band-hostile. Shared by the
    unstructured load and material sweep compilers."""
    from ..fem.dia import build_dia_structure
    from ..meshing.reorder import renumber as _renumber
    from ..bc import BCArrays

    n = mesh.num_nodes
    perm = None
    bca = base_bca
    dia = build_dia_structure(mesh.tris, n, max_diags=max_diags)
    if dia is None:
        mesh_r, perm_r, _stats = _renumber(mesh)
        dia = build_dia_structure(mesh_r.tris, n, max_diags=max_diags)
        if dia is None:
            raise ValueError(
                "mesh is band-hostile even after renumbering; use "
                + fallback_hint
            )
        mesh, perm = mesh_r, perm_r
        bca = BCArrays(
            u_known=base_bca.u_known[perm],
            u_value=base_bca.u_value[perm],
            f_value=base_bca.f_value[perm],
        )
    return mesh, bca, dia, perm
#
# Fast sweeps on ARBITRARY meshes (delaunay/gmsh -- the reference's real
# inputs): band-renumber, assemble DIA bands once, and precondition every
# lane with ONE smoothed-aggregation AMG hierarchy (fem/amg.py). The
# variants differ from the base operator only by the per-lane scale s_b
# (Young's modulus x thickness at fixed Poisson ratio), and the V-cycle is
# linear, so V((s_b K))^-1 = (1/s_b) V(K)^-1 -- the shared hierarchy is the
# EXACT AMG preconditioner for each lane. Iteration counts drop from the
# block-Jacobi lanes' O(1/h) lockstep to the mesh-independent ~15-30.


def _dia_amg_lanes_core(
    bands, bands_sm, offsets, amg, d_mat, b_mat, free, u_fixed, f_applied,
    k_scales, tris, iterations, amg_sweeps=0,
):
    """bands: CG-precision DIA bands (f64 under mixed precision -- the
    kappa*eps_f32 true-residual wall caps pure-f32 force-driven lanes at
    ~1e-3 relative; f64 CG restores deep convergence). bands_sm: f32 bands
    for the V-cycle's level-0 smoothing, matching the f32 hierarchy."""
    from ..fem.amg import make_amg_preconditioner

    cgt = bands.dtype
    u_fixed = u_fixed.transpose(2, 1, 0).astype(cgt)  # [2, N, B]
    f_applied = f_applied.transpose(2, 1, 0).astype(cgt)
    free_b = free.astype(cgt)[:, :, None]
    free_sm = free.astype(bands_sm.dtype)[:, :, None]
    k_scales = k_scales.astype(cgt)

    def band_matvec(bk, u):  # UNSCALED K u on [2, N, B] lane fields
        return lane_dia_matvec(bk, offsets, u)

    def op_sm(v):  # f32 reduced base operator (the hierarchy's level 0)
        return free_sm * band_matvec(bands_sm, free_sm * v) + (
            1.0 - free_sm
        ) * v

    def op(v):  # per-lane CG operator K_b = s_b K
        return (
            free_b * (band_matvec(bands, free_b * v) * k_scales)
            + (1.0 - free_b) * v
        )

    # unscaled reduced block-Jacobi inverse (f32): the level-0 smoother
    # (shared BC-reduction + degenerate-block guard: parallel/blocks)
    from .blocks import guarded_inv2, reduce_diag_blocks

    zero_idx = offsets.index(0)
    d = reduce_diag_blocks(bands_sm[zero_idx], free_sm[:, :, 0])
    inv_b = guarded_inv2(d)[:, :, :, None]

    def jac0(r):
        p0 = inv_b[0, 0] * r[0] + inv_b[0, 1] * r[1]
        p1 = inv_b[1, 0] * r[0] + inv_b[1, 1] * r[1]
        return jnp.stack([p0, p1])

    # one shared f32 V-cycle, un-scaled per lane on the way out (exact:
    # V((s K))^-1 = (1/s) V(K)^-1 on free DOFs, identity on fixed). Under
    # mixed precision the residual is normalized per lane before the f32
    # cast (linearity makes the rescale exact; mirrors fem/solve.py).
    # fixed-iteration lanes: a static budget cannot harvest an iteration
    # cut, so auto stays V(1,1) even for refined f64 lanes (extra sweeps
    # would be pure added cost per solve); amg_sweeps pins a stronger
    # cycle for callers who also shrink `iterations` to match
    from ..fem.amg import amg_sweep_schedule

    sweeps = amg_sweep_schedule(False, amg_sweeps)
    vcycle = make_amg_preconditioner(
        amg, op_sm, jac0, layout="tl", pre_sweeps=sweeps, post_sweeps=sweeps,
        a_op=lambda v: free_sm * band_matvec(bands_sm, free_sm * v),
    )
    inv_scale = free_b / k_scales + (1.0 - free_b)

    def precond(r):
        nrm = jnp.sqrt(_lane_dot(r, r))  # [B]
        safe = jnp.where(nrm == 0, jnp.ones_like(nrm), nrm)
        z = vcycle((r / safe).astype(bands_sm.dtype)).astype(cgt) * safe
        return z * inv_scale

    rhs = (
        free_b * (f_applied - band_matvec(bands, u_fixed) * k_scales)
        + (1.0 - free_b) * u_fixed
    )
    result = pcg_fixed_iterations(
        op,
        rhs,
        preconditioner=precond,
        x0=u_fixed,
        iterations=iterations,
        dot=_lane_dot,
    )
    u = result.x  # [2, N, B]

    dm = d_mat.astype(cgt)
    ks = k_scales[None, :]

    def sigma_fn(strain):  # [C, 3, B] -> per-lane stress components
        sig = jnp.einsum("rs,esb->erb", dm, strain, precision="highest")
        return sig[:, 0] * ks, sig[:, 1] * ks, sig[:, 2] * ks

    vm = _chunked_lane_vm(u, tris, b_mat, sigma_fn)
    return (
        u.transpose(2, 1, 0),  # [B, N, 2]
        result.residual_norm,  # [B]
        vm.T,  # [B, E]
        jnp.sqrt(_lane_dot(rhs, rhs)),  # [B]
    )


@partial(jax.jit, static_argnames=("offsets", "iterations", "amg_sweeps"))
def _dia_amg_lanes_jit(bands, bands_sm, offsets, amg, d_mat, b_mat, free,
                       u_fixed, f_applied, k_scales, tris, iterations,
                       amg_sweeps):
    return _dia_amg_lanes_core(
        bands, bands_sm, offsets, amg, d_mat, b_mat, free, u_fixed,
        f_applied, k_scales, tris, iterations, amg_sweeps,
    )


@partial(jax.jit, static_argnames=("offsets", "iterations", "amg_sweeps"))
def _dia_amg_lanes_factors_jit(
    bands, bands_sm, offsets, amg, d_mat, b_mat, free, u_base, f_base,
    u_factors, f_factors, k_scales, tris, iterations, amg_sweeps,
):
    u_fixed, f_applied = _factor_fields(u_base, f_base, u_factors, f_factors)
    return _dia_amg_lanes_core(
        bands, bands_sm, offsets, amg, d_mat, b_mat, free, u_fixed,
        f_applied, k_scales, tris, iterations, amg_sweeps,
    )


@dataclass
class CompiledUnstructuredSweep:
    """An arbitrary mesh compiled for repeated AMG-preconditioned sweeps.

    Setup (band renumbering, DIA assembly, the AMG hierarchy build) runs
    once; `solve(u_values, f_values, k_scales)` pays only the lane-batched
    PCG. `amg_setup` is the host hierarchy (persistable via
    persist.save_amg and reusable by compile_problem on the same mesh)."""

    bands: jax.Array  # CG-precision (f64 when refined)
    bands_sm: jax.Array  # f32 smoothing bands (same array when pure-f32)
    offsets: tuple
    amg: tuple
    d_mat: jax.Array
    b_mat: jax.Array
    free: jax.Array  # [2, N]
    tris: jax.Array  # renumbered
    perm: object  # perm[new] = old, or None
    iterations: int
    dtype: object
    amg_setup: object
    n_nodes: int
    # lanes shard over this jax.sharding.Mesh (None = single device)
    device_mesh: object = None
    # V-cycle schedule override (0 = auto; fem.amg.amg_sweep_schedule)
    amg_sweeps: int = 0
    # device index arrays for the renumbering gather (see _perm_nodes)
    perm_dev: object = None
    iperm_dev: object = None
    # compile-time base BC values in the RENUMBERED node order (device
    # arrays; feed solve_factors)
    u_base: object = None
    f_base: object = None

    def _batch(self, arr):
        if self.device_mesh is not None:
            return _shard_lanes(self.device_mesh, arr, self.dtype)
        return jnp.asarray(arr, dtype=self.dtype)

    def solve_factors(self, u_factors, f_factors, k_scales) -> SweepResult:
        """Load-factor sweep: lane b solves the compile-time BCs scaled by
        (u_factors[b], f_factors[b]) -- u_fixed = u_factors[b] * u_base,
        f_applied = f_factors[b] * f_base, built on device. Uploads three
        [B] vectors per batch instead of two dense [B, N, 2] fields;
        results are identical to the equivalent dense solve().
        """
        u, res, vm, rhs_norm = _dia_amg_lanes_factors_jit(
            self.bands,
            self.bands_sm,
            self.offsets,
            self.amg,
            self.d_mat,
            self.b_mat,
            self.free,
            self.u_base,
            self.f_base,
            self._batch(u_factors),
            self._batch(f_factors),
            self._batch(k_scales),
            self.tris,
            self.iterations,
            self.amg_sweeps,
        )
        if self.iperm_dev is not None:
            u = _perm_nodes(u, self.iperm_dev)
        return SweepResult(
            u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm
        )

    def solve(self, u_values, f_values, k_scales) -> SweepResult:
        up = self._batch(u_values)
        fp = self._batch(f_values)
        if self.perm_dev is not None:
            up = _perm_nodes(up, self.perm_dev)
            fp = _perm_nodes(fp, self.perm_dev)
        u, res, vm, rhs_norm = _dia_amg_lanes_jit(
            self.bands,
            self.bands_sm,
            self.offsets,
            self.amg,
            self.d_mat,
            self.b_mat,
            self.free,
            up,
            fp,
            self._batch(k_scales),
            self.tris,
            self.iterations,
            self.amg_sweeps,
        )
        if self.iperm_dev is not None:
            u = _perm_nodes(u, self.iperm_dev)
        return SweepResult(
            u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm
        )


def compile_unstructured_sweep(
    mesh: Mesh,
    base_bca: BCArrays,
    metadata: ModelMetadata,
    iterations: int = 30,
    dtype=np.float32,
    amg_setup=None,
    cell_factor: float = 3.0,
    max_diags: int = 96,
    refined=None,
    device_mesh=None,
    amg_sweeps: int = 0,
) -> CompiledUnstructuredSweep:
    """Compile an arbitrary (delaunay/gmsh) mesh for AMG-lane sweeps.

    `device_mesh`: a jax.sharding.Mesh to shard the LANE axis over (pure
    data parallelism; the DIA bands + AMG hierarchy replicate, each device
    solves its slice of the variants with no solve-time collectives).

    Band-renumbers band-hostile meshes (meshing/reorder.py), assembles the
    DIA operator once, and builds (or validates a provided) AMG hierarchy.
    Raises ValueError when the mesh stays band-hostile after renumbering --
    callers fall back to sweep_solve's vmap path.

    `refined` (default: auto = on when jax_enable_x64 and dtype is f32):
    f64 CG over f64 bands with the f32 V-cycle preconditioner -- pure-f32
    lanes hit the kappa*eps_f32 true-residual wall (~1e-3 relative on
    force-driven cases); mixed precision restores ~1e-7 at roughly 2x the
    band-matvec bandwidth.

    `amg_sweeps` pins the V-cycle schedule (0 = auto V(1,1); a fixed
    iteration budget cannot harvest an iteration cut on its own). For
    REFINED lanes, amg_sweeps=3 with `iterations` shrunk to ~0.6x reaches
    the same residual (1e-8 relative at V(1,1)x13 vs V(3,3)x8 on a
    3.8k-node delaunay mesh); which is cheaper depends on the relative
    cost of the f64 matvec and the f32 V-cycle on the device.
    """
    from ..utils.jaxcache import ensure_default_cache

    ensure_default_cache()
    from ..fem.amg import amg_device_arrays, build_amg_setup, setup_matches

    n = mesh.num_nodes
    mesh, bca, dia, perm = _banded_mesh_or_raise(
        mesh, base_bca, max_diags, "sweep_solve's vmap path"
    )

    free_np = (~bca.u_known).astype(np.float64)
    if amg_setup is None or not setup_matches(
        amg_setup, mesh.coords, mesh.tris, free_np, metadata, cell_factor,
        perm,
    ):
        amg_setup = build_amg_setup(
            mesh.coords,
            mesh.tris,
            metadata.youngs_modulus,
            metadata.poisson_ratio,
            metadata.part_thickness,
            free_np,
            cell_factor=cell_factor,
        )
    if refined is None:
        refined = bool(jax.config.jax_enable_x64) and dtype == np.float32
    sm_dtype = np.float32 if dtype == np.float32 else dtype
    cg_dtype = np.float64 if refined else dtype
    # lanes=True: the lane-batched ("tl") V-cycle smooths coarse levels on
    # the gather ELL (the DIA coarse bands serve only single-vector
    # layouts), and skips uploading what it never applies
    amg = amg_device_arrays(amg_setup, sm_dtype, lanes=True)
    if not amg_setup.transfers:
        # the mesh is too small to coarsen (n*2 <= the dense-coarse
        # threshold): the V-cycle would degenerate to block-Jacobi. Build
        # the EXACT dense inverse of the reduced operator instead -- one
        # [2N, 2N] dense matmul per application, CG converges in ~2 sweeps.
        from ..fem.amg import _assemble_block_coo

        ar, ac, av = _assemble_block_coo(
            mesh.coords,
            mesh.tris,
            float(metadata.youngs_modulus),
            float(metadata.poisson_ratio),
            float(metadata.part_thickness),
            free_np,
        )
        dense = np.zeros((n, 2, n, 2))
        np.add.at(dense, (ar, slice(None), ac, slice(None)), av)
        dense = dense.reshape(2 * n, 2 * n)
        fixed = (1.0 - free_np).reshape(-1)
        dense[np.arange(2 * n), np.arange(2 * n)] += fixed
        amg = ((), (), (jnp.asarray(np.linalg.inv(dense), dtype=sm_dtype),))

    from ..fem.element import (
        element_areas,
        gather_element_coords,
        strain_displacement_matrices,
        stress_strain_matrix,
    )

    coords = jnp.asarray(mesh.coords, dtype=cg_dtype)
    tris = jnp.asarray(mesh.tris)
    ke = element_stiffness_matrices(
        coords,
        tris,
        metadata.youngs_modulus,
        metadata.poisson_ratio,
        metadata.part_thickness,
    )
    bands = assemble_dia(ke, dia.slot_ids, n, dia.n_diags)
    bands_sm = bands.astype(sm_dtype) if cg_dtype != sm_dtype else bands
    ecoords = gather_element_coords(coords, tris).astype(sm_dtype)
    areas = element_areas(ecoords)
    b_mat = strain_displacement_matrices(ecoords, areas)
    d_mat = stress_strain_matrix(
        metadata.youngs_modulus, metadata.poisson_ratio, dtype=sm_dtype
    )
    free = jnp.asarray((~bca.u_known).T.astype(sm_dtype))

    u_base = jnp.asarray(bca.u_value, dtype=dtype)
    f_base = jnp.asarray(bca.f_value, dtype=dtype)
    if device_mesh is not None:
        (bands, bands_sm, amg, d_mat, b_mat, free, tris, u_base,
         f_base) = _replicate_tree(
            device_mesh,
            (bands, bands_sm, amg, d_mat, b_mat, free, tris, u_base,
             f_base),
        )
    perm_dev, iperm_dev = _perm_arrays(perm, device_mesh)
    return CompiledUnstructuredSweep(
        bands=jax.block_until_ready(bands),
        bands_sm=bands_sm,
        offsets=tuple(int(o) for o in dia.offsets),
        amg=amg,
        d_mat=d_mat,
        b_mat=b_mat,
        free=free,
        tris=tris,
        perm=perm,
        iterations=int(iterations),
        dtype=dtype,
        amg_setup=amg_setup,
        n_nodes=n,
        device_mesh=device_mesh,
        amg_sweeps=int(amg_sweeps),
        perm_dev=perm_dev,
        iperm_dev=iperm_dev,
        u_base=u_base,
        f_base=f_base,
    )


# ----------- unstructured TRUE material sweeps (basis AMG lanes) ------------
#
# (E, nu, t) per lane on ARBITRARY meshes: three basis DIA band sets span
# every material (K(w) = wa*Ka + wb*Kb + wc*Kc, see fem/amg.py's material
# hierarchy), transfers are shared, and every level's operator/diagonal is
# combined per lane on the fly -- each lane is preconditioned by the EXACT
# V-cycle of ITS OWN operator. Per-lane diagonal inverses are closed-form
# (2x2 Cramer at level 0, 3x3 cofactors below) over [.., B] lane fields;
# XLA fuses the cofactor arithmetic into the smoother's FMA chain.


def _basis_element_stiffness(coords, tris, dcoef):
    """ke [E,6,6] for one unit D-basis (d0,d1,d2) = dcoef, t = 1."""
    from ..fem.element import (
        element_areas,
        gather_element_coords,
        strain_displacement_matrices,
    )

    ecoords = gather_element_coords(coords, tris)
    areas = element_areas(ecoords)
    b = strain_displacement_matrices(ecoords, areas)  # [E,3,6]
    d = jnp.asarray(
        [
            [dcoef[0], dcoef[1], 0.0],
            [dcoef[1], dcoef[0], 0.0],
            [0.0, 0.0, dcoef[2]],
        ],
        dtype=coords.dtype,
    )
    db = jnp.einsum("rs,esj->erj", d, b, precision="highest")
    ke = jnp.einsum("eri,erj->eij", b, db, precision="highest")
    return ke * areas[:, None, None]


def _lane_weighted_band_matvec(bands3, offsets, wa, wb, wc, u):
    """y = (wa*Ka + wb*Kb + wc*Kc) u on [2, N, B] lane fields.

    bands3: TUPLE of three [D, 2, 2, N] basis band sets, kept as separate
    arrays like the k-scale path's bands. One roll per offset feeds all
    three bases; the combination fuses into the FMA chain."""
    # SIX per-basis accumulators with [N, 1]-broadcast band coefficients --
    # the same fusion pattern the k-scale lanes use. Combining the basis
    # blocks per offset instead ([2,2,N,B] per-lane blocks) made XLA
    # materialize every offset's combined block concurrently: ~25 GB.
    acc = [jnp.zeros_like(u[0]) for _ in range(6)]
    for d_idx, off in enumerate(offsets):
        s = jnp.roll(u, -off, axis=1) if off != 0 else u
        for k, bk in enumerate(bands3):
            blk = bk[d_idx][:, :, :, None]  # [2, 2, N, 1]
            acc[2 * k] = acc[2 * k] + blk[0, 0] * s[0] + blk[0, 1] * s[1]
            acc[2 * k + 1] = (
                acc[2 * k + 1] + blk[1, 0] * s[0] + blk[1, 1] * s[1]
            )
    y0 = acc[0] * wa + acc[2] * wb + acc[4] * wc
    y1 = acc[1] * wa + acc[3] * wb + acc[5] * wc
    return jnp.stack([y0, y1])


# per-lane guarded 2x2 solve lives in parallel/blocks (shared with the
# node-sharded DIA path so the degenerate-block guard never diverges)


def _lane_inv3_apply(d, r):
    """Per-lane guarded 3x3 solve: d [n,3,3,B], r [n,3,B] -> d^-1 r.

    Closed-form adjugate (inverse = cof^T / det); rows whose det is tiny
    relative to the block scale solve to 0 (degenerate aggregates), the
    _guarded_inverse semantics carried per lane."""
    c00 = d[:, 1, 1] * d[:, 2, 2] - d[:, 1, 2] * d[:, 2, 1]
    c01 = d[:, 1, 2] * d[:, 2, 0] - d[:, 1, 0] * d[:, 2, 2]
    c02 = d[:, 1, 0] * d[:, 2, 1] - d[:, 1, 1] * d[:, 2, 0]
    c10 = d[:, 0, 2] * d[:, 2, 1] - d[:, 0, 1] * d[:, 2, 2]
    c11 = d[:, 0, 0] * d[:, 2, 2] - d[:, 0, 2] * d[:, 2, 0]
    c12 = d[:, 0, 1] * d[:, 2, 0] - d[:, 0, 0] * d[:, 2, 1]
    c20 = d[:, 0, 1] * d[:, 1, 2] - d[:, 0, 2] * d[:, 1, 1]
    c21 = d[:, 0, 2] * d[:, 1, 0] - d[:, 0, 0] * d[:, 1, 2]
    c22 = d[:, 0, 0] * d[:, 1, 1] - d[:, 0, 1] * d[:, 1, 0]
    det = d[:, 0, 0] * c00 + d[:, 0, 1] * c01 + d[:, 0, 2] * c02
    scale = jnp.max(jnp.abs(d), axis=(1, 2))
    bad = jnp.abs(det) <= 1e-12 * jnp.maximum(scale, 1e-30) ** 3
    safe = jnp.where(bad, jnp.ones_like(det), det)
    x0 = (c00 * r[:, 0] + c01 * r[:, 1] + c02 * r[:, 2]) / safe
    x1 = (c10 * r[:, 0] + c11 * r[:, 1] + c12 * r[:, 2]) / safe
    x2 = (c20 * r[:, 0] + c21 * r[:, 1] + c22 * r[:, 2]) / safe
    zero = jnp.zeros_like(x0)
    x0 = jnp.where(bad, zero, x0)
    x1 = jnp.where(bad, zero, x1)
    x2 = jnp.where(bad, zero, x2)
    return jnp.stack([x0, x1, x2], axis=1)


def _material_amg_vcycle(
    mamg,
    op0,
    jac0,
    wa,
    wb,
    wc,
    *,
    omega0=0.7,
    omega=0.7,
    coarse_sweeps=24,
    pre_sweeps=1,
    post_sweeps=1,
):
    """V(pre,post)-cycle over the basis hierarchy, exact per lane.

    mamg: pytree from fem.amg.material_amg_device_arrays. op0/jac0: the
    lane-weighted level-0 operator and diag-inverse apply in the [2, N, B]
    band layout. wa/wb/wc [B] in the hierarchy's dtype."""
    from ..fem.amg import _block_ell_matvec

    transfers, coarse = mamg
    n_coarse = len(coarse)

    def mv(l, x):  # x [n, m, B]
        a_cols, (av_a, av_b, av_c), _ = coarse[l]
        xg = x[a_cols]  # [n, w, m, B] -- ONE gather feeds all three bases
        ya = jnp.einsum("nwij,nwjb->nib", av_a, xg, precision="highest")
        yb = jnp.einsum("nwij,nwjb->nib", av_b, xg, precision="highest")
        yc = jnp.einsum("nwij,nwjb->nib", av_c, xg, precision="highest")
        return ya * wa + yb * wb + yc * wc

    def dinv(l, r):  # r [n, 3, B]
        _, _, (d_a, d_b, d_c) = coarse[l]
        d = (
            d_a[:, :, :, None] * wa
            + d_b[:, :, :, None] * wb
            + d_c[:, :, :, None] * wc
        )
        return _lane_inv3_apply(d, r)

    def cycle(l, r):
        if l == n_coarse - 1:
            e = jnp.zeros_like(r)
            for _ in range(coarse_sweeps):
                e = e + omega * dinv(l, r - mv(l, e))
            return e
        e = omega * dinv(l, r)
        for _ in range(pre_sweeps - 1):
            e = e + omega * dinv(l, r - mv(l, e))
        res = r - mv(l, e)
        tp_cols, tp_vals, tpt_cols, tpt_vals = transfers[l + 1]
        rc = _block_ell_matvec(tpt_cols, tpt_vals, res)
        ec = cycle(l + 1, rc)
        e = e + _block_ell_matvec(tp_cols, tp_vals, ec)
        for _ in range(post_sweeps):
            e = e + omega * dinv(l, r - mv(l, e))
        return e

    def apply(r):  # r [2, N, B]
        e = omega0 * jac0(r)
        if not transfers:
            return e
        for _ in range(pre_sweeps - 1):
            e = e + omega0 * jac0(r - op0(e))
        res = (r - op0(e)).transpose(1, 0, 2)  # [N, 2, B]
        p_cols, p_vals, pt_cols, pt_vals = transfers[0]
        rc = _block_ell_matvec(pt_cols, pt_vals, res)
        ec = cycle(0, rc)
        e = e + _block_ell_matvec(p_cols, p_vals, ec).transpose(1, 0, 2)
        for _ in range(post_sweeps):
            e = e + omega0 * jac0(r - op0(e))
        return e

    return apply


def _material_dia_amg_lanes_core(
    bands3, bands3_sm, offsets, mamg, b_mat, free, u_fixed, f_applied,
    e_mods, nus, ts, tris, iterations, amg_sweeps=0,
):
    cgt = bands3[0].dtype
    smt = bands3_sm[0].dtype
    u_fixed = u_fixed.transpose(2, 1, 0).astype(cgt)  # [2, N, B]
    f_applied = f_applied.transpose(2, 1, 0).astype(cgt)
    free_b = free.astype(cgt)[:, :, None]
    free_sm = free.astype(smt)[:, :, None]
    wa, wb, wc = material_weights(
        e_mods.astype(cgt), nus.astype(cgt), ts.astype(cgt)
    )
    wa32, wb32, wc32 = (w.astype(smt) for w in (wa, wb, wc))

    def weighted_mv(b3, w3, u):
        return _lane_weighted_band_matvec(b3, offsets, *w3, u)

    def op(v):
        y = weighted_mv(bands3, (wa, wb, wc), free_b * v)
        return free_b * y + (1.0 - free_b) * v

    def op_sm(v):
        y = weighted_mv(bands3_sm, (wa32, wb32, wc32), free_sm * v)
        return free_sm * y + (1.0 - free_sm) * v

    # level-0 per-lane reduced diag inverse (f32): basis diagonals combined
    # by lane weights, BC-reduced, 2x2 Cramer per (node, lane)
    from .blocks import reduce_diag_blocks, solve2

    zero_idx = offsets.index(0)
    d3 = tuple(b[zero_idx] for b in bands3_sm)  # 3 x [2, 2, N]
    dd = reduce_diag_blocks(
        d3[0][:, :, :, None] * wa32
        + d3[1][:, :, :, None] * wb32
        + d3[2][:, :, :, None] * wc32,
        free_sm,  # [2, N, 1] broadcasts over the lane axis
    )

    def jac0(r):
        return solve2(dd, r)

    # fixed-iteration lanes: auto V(1,1) -- a static budget cannot
    # harvest an iteration cut (see _dia_amg_lanes_core); amg_sweeps
    # pins a stronger cycle for callers who also shrink `iterations`
    from ..fem.amg import amg_sweep_schedule

    sweeps = amg_sweep_schedule(False, amg_sweeps)
    vcycle = _material_amg_vcycle(
        mamg, op_sm, jac0, wa32, wb32, wc32,
        pre_sweeps=sweeps, post_sweeps=sweeps,
    )

    def precond(r):
        nrm = jnp.sqrt(_lane_dot(r, r))  # [B]
        safe = jnp.where(nrm == 0, jnp.ones_like(nrm), nrm)
        return vcycle((r / safe).astype(smt)).astype(cgt) * safe

    rhs = (
        free_b
        * (f_applied - weighted_mv(bands3, (wa, wb, wc), u_fixed))
        + (1.0 - free_b) * u_fixed
    )
    result = pcg_fixed_iterations(
        op,
        rhs,
        preconditioner=precond,
        x0=u_fixed,
        iterations=iterations,
        dot=_lane_dot,
    )
    u = result.x  # [2, N, B]

    # per-lane stress: sigma = D(E_b, nu_b) B u_b (thickness cancels)
    sa = wa / ts.astype(cgt)  # d0 per lane
    sb = wb / ts.astype(cgt)
    sc = wc / ts.astype(cgt)

    def sigma_fn(strain):  # [C, 3, B]
        s0 = sa * strain[:, 0] + sb * strain[:, 1]
        s1 = sb * strain[:, 0] + sa * strain[:, 1]
        s2 = sc * strain[:, 2]
        return s0, s1, s2

    vm = _chunked_lane_vm(u, tris, b_mat, sigma_fn)
    return (
        u.transpose(2, 1, 0),
        result.residual_norm,
        vm.T,
        jnp.sqrt(_lane_dot(rhs, rhs)),
    )


@partial(jax.jit, static_argnames=("offsets", "iterations", "amg_sweeps"))
def _material_dia_amg_lanes_jit(
    bands3, bands3_sm, offsets, mamg, b_mat, free, u_fixed, f_applied,
    e_mods, nus, ts, tris, iterations, amg_sweeps,
):
    return _material_dia_amg_lanes_core(
        bands3, bands3_sm, offsets, mamg, b_mat, free, u_fixed, f_applied,
        e_mods, nus, ts, tris, iterations, amg_sweeps,
    )


@partial(jax.jit, static_argnames=("offsets", "iterations", "amg_sweeps"))
def _material_dia_amg_lanes_factors_jit(
    bands3, bands3_sm, offsets, mamg, b_mat, free, u_base, f_base,
    u_factors, f_factors, e_mods, nus, ts, tris, iterations, amg_sweeps,
):
    u_fixed, f_applied = _factor_fields(u_base, f_base, u_factors, f_factors)
    return _material_dia_amg_lanes_core(
        bands3, bands3_sm, offsets, mamg, b_mat, free, u_fixed, f_applied,
        e_mods, nus, ts, tris, iterations, amg_sweeps,
    )


@dataclass
class CompiledUnstructuredMaterialSweep:
    """An arbitrary mesh compiled for (E, nu, t)-per-lane sweeps."""

    bands3: tuple  # 3 x [D, 2, 2, N] basis band sets, CG precision
    bands3_sm: tuple  # f32 smoothing copies (same tuple when pure f32)
    offsets: tuple
    mamg: tuple
    b_mat: jax.Array
    free: jax.Array
    tris: jax.Array
    perm: object
    iterations: int
    dtype: object
    material_setup: object
    n_nodes: int
    # lanes shard over this jax.sharding.Mesh (None = single device)
    device_mesh: object = None
    # V-cycle schedule override (0 = auto; fem.amg.amg_sweep_schedule)
    amg_sweeps: int = 0
    # device index arrays for the renumbering gather (see _perm_nodes)
    perm_dev: object = None
    iperm_dev: object = None
    # compile-time base BC values in the RENUMBERED node order (device
    # arrays; feed solve_factors)
    u_base: object = None
    f_base: object = None

    def _batch(self, arr):
        if self.device_mesh is not None:
            return _shard_lanes(self.device_mesh, arr, self.dtype)
        return jnp.asarray(arr, dtype=self.dtype)

    def solve_factors(
        self, u_factors, f_factors, e_moduli, poisson_ratios, thicknesses
    ) -> SweepResult:
        """Load-factor material sweep: per-lane (E, nu, t) plus per-lane
        scalings of the compile-time BC values, built on device (see
        CompiledUnstructuredSweep.solve_factors)."""
        u, res, vm, rhs_norm = _material_dia_amg_lanes_factors_jit(
            self.bands3,
            self.bands3_sm,
            self.offsets,
            self.mamg,
            self.b_mat,
            self.free,
            self.u_base,
            self.f_base,
            self._batch(u_factors),
            self._batch(f_factors),
            self._batch(e_moduli),
            self._batch(poisson_ratios),
            self._batch(thicknesses),
            self.tris,
            self.iterations,
            self.amg_sweeps,
        )
        if self.iperm_dev is not None:
            u = _perm_nodes(u, self.iperm_dev)
        return SweepResult(
            u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm
        )

    def solve(
        self, u_values, f_values, e_moduli, poisson_ratios, thicknesses
    ) -> SweepResult:
        up = self._batch(u_values)
        fp = self._batch(f_values)
        if self.perm_dev is not None:
            up = _perm_nodes(up, self.perm_dev)
            fp = _perm_nodes(fp, self.perm_dev)
        u, res, vm, rhs_norm = _material_dia_amg_lanes_jit(
            self.bands3,
            self.bands3_sm,
            self.offsets,
            self.mamg,
            self.b_mat,
            self.free,
            up,
            fp,
            self._batch(e_moduli),
            self._batch(poisson_ratios),
            self._batch(thicknesses),
            self.tris,
            self.iterations,
            self.amg_sweeps,
        )
        if self.iperm_dev is not None:
            u = _perm_nodes(u, self.iperm_dev)
        return SweepResult(
            u=u, residual_norm=res, von_mises=vm, rhs_norm=rhs_norm
        )


def compile_unstructured_material_sweep(
    mesh: Mesh,
    base_bca: BCArrays,
    iterations: int = 35,
    dtype=np.float32,
    nu_ref: float = 0.3,
    cell_factor: float = 3.0,
    max_diags: int = 96,
    refined=None,
    device_mesh=None,
    amg_sweeps: int = 0,
) -> CompiledUnstructuredMaterialSweep:
    """Compile an arbitrary mesh for TRUE material sweeps.

    `device_mesh`: a jax.sharding.Mesh to shard the LANE axis over (pure
    data parallelism; basis bands + basis hierarchy replicate).

    Three basis DIA band sets + the basis AMG hierarchy
    (fem/amg.build_amg_material_setup) give every lane the exact V-cycle
    of its own (E, nu, t) operator; transfers are built once at `nu_ref`.
    Band-hostile meshes renumber first; raises ValueError when the mesh
    stays band-hostile (fall back to per-variant solve_system).

    `amg_sweeps`: see compile_unstructured_sweep -- auto V(1,1)."""
    from ..utils.jaxcache import ensure_default_cache

    ensure_default_cache()
    from ..fem.amg import (
        _UNIT_DCOEFS,
        build_amg_material_setup,
        material_amg_device_arrays,
    )
    n = mesh.num_nodes
    mesh, bca, dia, perm = _banded_mesh_or_raise(
        mesh, base_bca, max_diags, "per-variant solve_system"
    )

    if refined is None:
        refined = bool(jax.config.jax_enable_x64) and dtype == np.float32
    sm_dtype = np.float32 if dtype == np.float32 else dtype
    cg_dtype = np.float64 if refined else dtype

    free_np = (~bca.u_known).astype(np.float64)
    material_setup = build_amg_material_setup(
        mesh.coords, mesh.tris, free_np, nu_ref=nu_ref,
        cell_factor=cell_factor,
    )
    mamg = material_amg_device_arrays(material_setup, sm_dtype)

    from ..fem.element import (
        element_areas,
        gather_element_coords,
        strain_displacement_matrices,
    )

    coords = jnp.asarray(mesh.coords, dtype=cg_dtype)
    tris = jnp.asarray(mesh.tris)
    bands3 = tuple(
        assemble_dia(
            _basis_element_stiffness(coords, tris, dc),
            dia.slot_ids,
            n,
            dia.n_diags,
        )
        for dc in _UNIT_DCOEFS
    )
    bands3_sm = (
        tuple(b.astype(sm_dtype) for b in bands3)
        if cg_dtype != sm_dtype
        else bands3
    )
    ecoords = gather_element_coords(coords, tris).astype(sm_dtype)
    areas = element_areas(ecoords)
    b_mat = strain_displacement_matrices(ecoords, areas)
    free = jnp.asarray((~bca.u_known).T.astype(sm_dtype))

    u_base = jnp.asarray(bca.u_value, dtype=dtype)
    f_base = jnp.asarray(bca.f_value, dtype=dtype)
    if device_mesh is not None:
        (bands3, bands3_sm, mamg, b_mat, free, tris, u_base,
         f_base) = _replicate_tree(
            device_mesh,
            (bands3, bands3_sm, mamg, b_mat, free, tris, u_base, f_base),
        )
    perm_dev, iperm_dev = _perm_arrays(perm, device_mesh)
    return CompiledUnstructuredMaterialSweep(
        bands3=jax.block_until_ready(bands3),
        bands3_sm=bands3_sm,
        offsets=tuple(int(o) for o in dia.offsets),
        mamg=mamg,
        b_mat=b_mat,
        free=free,
        tris=tris,
        perm=perm,
        iterations=int(iterations),
        dtype=dtype,
        material_setup=material_setup,
        n_nodes=n,
        device_mesh=device_mesh,
        amg_sweeps=int(amg_sweeps),
        perm_dev=perm_dev,
        iperm_dev=iperm_dev,
        u_base=u_base,
        f_base=f_base,
    )
