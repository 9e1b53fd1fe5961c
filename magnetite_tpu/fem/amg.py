"""Smoothed-aggregation algebraic multigrid for unstructured meshes.

The geometric multigrid in fem/multigrid.py needs a logical (rows, cols)
grid; meshes from the Delaunay/gmsh front-ends (the reference's primary
path, src/mesher.rs:939-974) have none, and block-Jacobi PCG iteration
counts on them grow O(1/h) -- ~3.5k iterations at 1M elements. This module
restores mesh-independent convergence for ANY triangle mesh.

Smoothed aggregation (Vanek/Mandel/Brezina):
  * aggregate nodes into spatially compact groups (geometric cell binning --
    both built-in mesh producers emit quasi-uniform meshes, so fixed-size
    cells of ~3 median edge lengths give ~9-node aggregates; fully
    vectorized, no sequential greedy pass)
  * tentative prolongator P0 from the elasticity near-nullspace (the three
    2D rigid-body modes  [1,0,-y], [0,1,x]  per node), orthonormalized per
    aggregate by batched QR; the R factors become the coarse-level
    near-nullspace, so every level keeps 3x3 node blocks
  * smoothed prolongator P = (I - omega D^-1 A) P0 with
    omega = 4/3 / rho(D^-1 A) (power-iteration estimate)
  * Galerkin coarse operators A_{l+1} = P^T A_l P, computed on host with
    chunked sort+reduce block-COO products (vectorized numpy; the setup is
    a one-time host cost, persisted with case checkpoints via
    persist.save_amg)

Host/device split: ALL setup runs on host in numpy (irregular, data-dependent
-- exactly what XLA is bad at); the V-cycle apply is a pure jitted function
over padded block-ELL arrays (static shapes, gather + einsum + segment-free
FMAs). Level 0 smoothing rides the injected fast operator (DIA/hybrid band
matvec), so the dominant per-iteration cost stays on the roll/FMA path.

The cycle is symmetric (matched damped block-Jacobi pre/post sweeps,
adjoint transfers), hence a valid SPD preconditioner for CG.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional

import jax
import jax.numpy as jnp
import numpy as np

MatVec = Callable[[jax.Array], jax.Array]

# exact coarsest solves above this are slower than extra smoothing
_DENSE_COARSE_MAX_DOF = 3072


# ============================ host setup ====================================


def _reduce_block_coo(keys, vals):
    """Sum duplicate keys: sorted unique keys + reduced block values.

    Native C++ pair-sort + one accumulation pass when available; numpy
    fallback does per-component bincount on the unique-inverse ids (one key
    sort total, and no [M, block] fancy-index gather, which dominated the
    sort+reduceat formulation at 1M-element scale)."""
    from ..native import sort_reduce_blocks

    if keys.size == 0:
        return keys.copy(), np.empty((0,) + vals.shape[1:])
    native = sort_reduce_blocks(keys, vals)
    if native is not None:
        return native
    uniq, inv = np.unique(keys, return_inverse=True)
    flat = vals.reshape(vals.shape[0], -1)
    out = np.empty((uniq.size, flat.shape[1]))
    for c in range(flat.shape[1]):
        out[:, c] = np.bincount(
            inv, weights=flat[:, c], minlength=uniq.size
        )
    return uniq, out.reshape(-1, *vals.shape[1:])


def _assemble_block_coo(coords, tris, e_mod, nu, t, free, dcoefs=None):
    """BC-masked global stiffness in block-COO, rows sorted.

    Rides the solver's ELL structure builder (native C++ when available) and
    bincount scatter instead of a 9E-entry argsort. ELL padding slots emit
    zero blocks at (n, n) -- duplicate diagonal keys with zero values, which
    every consumer (matvecs, RAP products, diag extraction via add.at)
    treats additively. free: [N,2] float mask (1 = unknown DOF).

    `dcoefs`: explicit (d0, d1, d2) plane-stress D coefficients overriding
    the (e_mod, nu) closed form -- the material-sweep basis assemblies pass
    unit vectors here (numpy path only; basis assemblies are small)."""
    from .assembly import build_ell_structure

    from ..native import amg_assemble as native_assemble
    from ..native import assemble_coo_blocks as native_assemble_coo

    n = coords.shape[0]
    # fastest path: direct sorted-COO assembly in one C++ pass (no ELL
    # structure build, no scatter storage)
    direct = (
        native_assemble_coo(coords, tris, free, e_mod, nu, t, n)
        if dcoefs is None
        else None
    )
    if direct is not None:
        keys, blocks = direct
        return (
            (keys // n).astype(np.int64),
            (keys % n).astype(np.int64),
            blocks,
        )
    s = build_ell_structure(tris, n)
    e = tris.shape[0]
    # pair-major slot ids matching the [3,3,E] field layout
    ids = (
        s.slot_ids.astype(np.int64).reshape(e, 3, 3).transpose(1, 2, 0).reshape(-1)
    )
    rows = np.repeat(np.arange(n, dtype=np.int64), s.width)
    cols = s.cols.reshape(-1).astype(np.int64)
    flat = (
        native_assemble(coords, tris, free, e_mod, nu, t, ids, n * s.width)
        if dcoefs is None
        else None
    )
    if flat is not None:
        return rows, cols, flat.reshape(-1, 2, 2)
    # numpy fallback: closed-form per-pair 2x2 blocks as scalar [3,3,E]
    # fields (the mirror of fem/element.pair_block_fields): no [E,6,6]
    # tensor, no block transpose copies
    at = tris.astype(np.int64).T  # [3, E]
    pc = coords[at]  # [3, E, 2]
    x, y = pc[..., 0], pc[..., 1]
    beta = np.stack([y[1] - y[2], y[2] - y[0], y[0] - y[1]])
    gamma = np.stack([x[2] - x[1], x[0] - x[2], x[1] - x[0]])
    area2 = x[0] * (y[1] - y[2]) + x[1] * (y[2] - y[0]) + x[2] * (y[0] - y[1])
    coef = t / (2.0 * area2)
    if dcoefs is None:
        d0 = e_mod / (1.0 - nu * nu)
        d1 = nu * d0
        d2 = 0.5 * (1.0 - nu) * d0
    else:
        d0, d1, d2 = dcoefs
    ba, bb = beta[:, None, :], beta[None, :, :]  # [3,3,E]
    ga, gb = gamma[:, None, :], gamma[None, :, :]
    fxa, fya = free[at, 0], free[at, 1]  # [3, E]
    m00 = fxa[:, None, :] * fxa[None, :, :]
    m01 = fxa[:, None, :] * fya[None, :, :]
    m10 = fya[:, None, :] * fxa[None, :, :]
    m11 = fya[:, None, :] * fya[None, :, :]
    k00 = coef * (d0 * ba * bb + d2 * ga * gb) * m00
    k01 = coef * (d1 * ba * gb + d2 * ga * bb) * m01
    k10 = coef * (d1 * ga * bb + d2 * ba * gb) * m10
    k11 = coef * (d0 * ga * gb + d2 * ba * bb) * m11
    flat = np.empty((n * s.width, 4))
    for c, k in enumerate((k00, k01, k10, k11)):
        flat[:, c] = np.bincount(
            ids, weights=k.reshape(-1), minlength=n * s.width
        )
    return rows, cols, flat.reshape(-1, 2, 2)


def _coo_to_ell(rows, cols, vals, n_rows):
    """Block-COO (rows sorted) -> padded block-ELL. Padding slots use col 0
    with zero blocks (harmless in the gather-einsum matvec)."""
    counts = np.bincount(rows, minlength=n_rows)
    width = max(int(counts.max()) if counts.size else 1, 1)
    starts = np.searchsorted(rows, np.arange(n_rows))
    ranks = np.arange(rows.size) - starts[rows]
    mi, mj = vals.shape[1], vals.shape[2]
    ell_cols = np.zeros((n_rows, width), dtype=np.int32)
    ell_vals = np.zeros((n_rows, width, mi, mj), dtype=vals.dtype)
    ell_cols[rows, ranks] = cols
    ell_vals[rows, ranks] = vals
    return ell_cols, ell_vals


def _diag_blocks(rows, cols, vals, n):
    m = vals.shape[1]
    d = np.zeros((n, m, m), dtype=vals.dtype)
    on_diag = rows == cols
    # add.at: diagonal keys may appear twice (ELL padding emits zero blocks)
    np.add.at(d, rows[on_diag], vals[on_diag])
    return d


def _guarded_inverse(d):
    """Batched m x m inverse (closed-form adjugate, m in {2, 3}); singular
    blocks (fully constrained nodes, degenerate aggregates) invert to 0 so
    the smoother leaves them alone. SVD-free: this runs per level at setup
    time and batched pinv dominated the whole setup otherwise."""
    n, m, _ = d.shape
    if m == 2:
        a, b = d[:, 0, 0], d[:, 0, 1]
        c, e = d[:, 1, 0], d[:, 1, 1]
        det = a * e - b * c
        adj = np.empty_like(d)
        adj[:, 0, 0], adj[:, 0, 1] = e, -b
        adj[:, 1, 0], adj[:, 1, 1] = -c, a
    elif m == 3:
        # adjugate (transposed cofactors)
        c00 = d[:, 1, 1] * d[:, 2, 2] - d[:, 1, 2] * d[:, 2, 1]
        c01 = d[:, 1, 2] * d[:, 2, 0] - d[:, 1, 0] * d[:, 2, 2]
        c02 = d[:, 1, 0] * d[:, 2, 1] - d[:, 1, 1] * d[:, 2, 0]
        det = d[:, 0, 0] * c00 + d[:, 0, 1] * c01 + d[:, 0, 2] * c02
        adj = np.empty_like(d)
        adj[:, 0, 0] = c00
        adj[:, 1, 0] = c01
        adj[:, 2, 0] = c02
        adj[:, 0, 1] = d[:, 0, 2] * d[:, 2, 1] - d[:, 0, 1] * d[:, 2, 2]
        adj[:, 1, 1] = d[:, 0, 0] * d[:, 2, 2] - d[:, 0, 2] * d[:, 2, 0]
        adj[:, 2, 1] = d[:, 0, 1] * d[:, 2, 0] - d[:, 0, 0] * d[:, 2, 1]
        adj[:, 0, 2] = d[:, 0, 1] * d[:, 1, 2] - d[:, 0, 2] * d[:, 1, 1]
        adj[:, 1, 2] = d[:, 0, 2] * d[:, 1, 0] - d[:, 0, 0] * d[:, 1, 2]
        adj[:, 2, 2] = d[:, 0, 0] * d[:, 1, 1] - d[:, 0, 1] * d[:, 1, 0]
    else:  # pragma: no cover - block sizes are fixed by construction
        raise ValueError(f"unsupported block size {m}")
    # relative singularity guard: |det| tiny vs the block's scale -> 0
    scale = np.abs(d).reshape(n, -1).max(axis=1)
    bad = np.abs(det) <= 1e-12 * np.maximum(scale, 1e-300) ** m
    safe = np.where(bad, 1.0, det)
    inv = adj / safe[:, None, None]
    inv[bad] = 0.0
    return inv


def _coo_matvec(rows, cols, vals, x, n):
    """Host block-COO matvec (rows sorted): power-iteration helper."""
    prod = np.matmul(vals, x[cols][..., None])[..., 0]
    out = np.zeros((n, x.shape[1]), dtype=x.dtype)
    first = np.ones(rows.size, dtype=bool)
    first[1:] = rows[1:] != rows[:-1]
    starts = np.flatnonzero(first)
    sums = np.add.reduceat(prod, starts, axis=0)
    out[rows[starts]] = sums
    return out


def _estimate_rho_dinv_a(rows, cols, vals, diag_inv, n, iters=8, seed=0):
    """rho(D^-1 A) by power iteration (host, native matvec when available)."""
    from ..native import coo_matvec_blocks

    rng = np.random.default_rng(seed)
    m = vals.shape[1]
    x = rng.standard_normal((n, m))
    x /= np.linalg.norm(x)
    rho = 1.0
    keys = rows * np.int64(n) + cols
    for _ in range(iters):
        y = coo_matvec_blocks(keys, vals, n, x)
        if y is None:
            y = _coo_matvec(rows, cols, vals, x, n)
        y = np.matmul(diag_inv, y[..., None])[..., 0]
        norm = np.linalg.norm(y)
        if norm == 0:
            return 1.0
        rho = norm
        x = y / norm
    return float(rho)


# Aggregates larger than this split into index-chunked sub-aggregates. The
# cell binning targets ~cell_factor^2 nodes per aggregate on quasi-uniform
# meshes; strongly GRADED meshes (characteristic_length_min << max) can pack
# thousands of finely-meshed nodes into one median-sized cell, and the
# padded per-aggregate QR would then allocate O(n_agg * max_size) memory.
_MAX_AGG_SIZE = 64


def _aggregate_cells(coords, cell):
    """Spatial cell aggregation: agg id per node + aggregate centroids."""
    mn = coords.min(axis=0)
    ix = np.floor((coords[:, 0] - mn[0]) / cell).astype(np.int64)
    iy = np.floor((coords[:, 1] - mn[1]) / cell).astype(np.int64)
    key = iy * (ix.max() + 1) + ix
    _, agg = np.unique(key, return_inverse=True)
    counts = np.bincount(agg)
    if counts.max() > _MAX_AGG_SIZE:
        # split oversized cells by position-in-cell chunks (spatially blind
        # within the cell, but bounded -- quality degrades only locally)
        order = np.argsort(agg, kind="stable")
        starts = np.searchsorted(agg[order], np.arange(counts.size))
        pos = np.empty(agg.size, dtype=np.int64)
        pos[order] = np.arange(agg.size) - starts[agg[order]]
        sub = pos // _MAX_AGG_SIZE
        _, agg = np.unique(agg * np.int64(sub.max() + 1) + sub, return_inverse=True)
    n_agg = int(agg.max()) + 1
    counts = np.bincount(agg, minlength=n_agg).astype(np.float64)
    cx = np.bincount(agg, coords[:, 0], minlength=n_agg) / counts
    cy = np.bincount(agg, coords[:, 1], minlength=n_agg) / counts
    return agg, np.stack([cx, cy], axis=-1)


def _tentative_prolongator(agg, n_agg, bmodes):
    """P0 + coarse near-nullspace by per-aggregate batched QR.

    bmodes: [n, m, 3] near-nullspace rows per node (zeroed at fixed DOFs).
    Returns (p0_block [n, m, 3] -- each node's single block, col = agg id,
    b_coarse [n_agg, 3, 3]).
    """
    n, m, nvec = bmodes.shape
    order = np.argsort(agg, kind="stable")
    counts = np.bincount(agg, minlength=n_agg)
    smax = int(counts.max())
    # padded stack [n_agg, smax*m, 3]; zero padding rows are QR-safe (their
    # Q rows reproduce zeros whenever R is used to reconstruct them)
    stacked = np.zeros((n_agg, smax * m, nvec))
    pos_in_agg = np.arange(n) - np.searchsorted(agg[order], np.arange(n_agg))[agg[order]]
    flat_rows = (pos_in_agg[:, None] * m + np.arange(m)[None, :]).reshape(-1)
    node_rows = np.repeat(order, m)
    agg_rows = np.repeat(agg[order], m)
    stacked[agg_rows, flat_rows] = bmodes[order].reshape(n * m, nvec)
    q, r = np.linalg.qr(stacked)  # q [n_agg, smax*m, 3], r [n_agg, 3, 3]
    p0 = np.zeros((n, m, nvec))
    p0[node_rows, np.tile(np.arange(m), n)] = q[agg_rows, flat_rows]
    return p0, r


def _smooth_prolongator(rows, cols, vals, diag_inv, agg, p0_block, n_agg, omega):
    """P = (I - omega D^-1 A) P0 in block-COO keyed (fine row, coarse col)."""
    from ..native import smooth_prolongator_blocks

    n = p0_block.shape[0]
    native = smooth_prolongator_blocks(
        rows * np.int64(n) + cols, vals, n, diag_inv, p0_block,
        agg, n_agg, omega,
    )
    if native is not None:
        k, v = native
        return (k // n_agg).astype(np.int64), (k % n_agg).astype(np.int64), v
    # - omega * Dinv A P0 term: every A entry (i, j) -> (i, agg[j])
    dinva = np.matmul(diag_inv[rows], vals)  # [nnz, m, m]
    contrib = -omega * np.matmul(dinva, p0_block[cols])
    keys = rows * np.int64(n_agg) + agg[cols]
    # + P0 term
    keys0 = np.arange(n, dtype=np.int64) * n_agg + agg
    keys_all = np.concatenate([keys, keys0])
    vals_all = np.concatenate([contrib, p0_block])
    k, v = _reduce_block_coo(keys_all, vals_all)
    return (k // n_agg).astype(np.int64), (k % n_agg).astype(np.int64), v


def _rap(
    arows, acols, avals, prows, pcols, pvals, n_agg, n_rows=None,
    chunk=2_000_000, filter_zeros=True,
):
    """Galerkin product P^T A P in block-COO.

    A: [nnz_a] blocks (m x m); P: [nnz_p] blocks (m x mc), rows sorted.
    Native C++ two-phase SpGEMM when available; chunked numpy sort+reduce
    otherwise. `filter_zeros=False` keeps the full structural pattern --
    the material-basis RAPs share one pattern across bases and filter on
    the combined norms afterwards.
    """
    from ..native import rap_blocks

    n = (
        int(n_rows)
        if n_rows is not None
        else (int(arows.max()) + 1 if arows.size else 0)
    )
    native = rap_blocks(
        arows * np.int64(n) + acols, avals, n,
        prows * np.int64(n_agg) + pcols, pvals, n_agg,
    )
    if native is not None:
        ck, cv = native
        if not filter_zeros:
            return (
                (ck // n_agg).astype(np.int64),
                (ck % n_agg).astype(np.int64),
                cv,
            )
        return _rap_filter(ck, cv, n_agg)
    p_ell_cols, p_ell_vals = _coo_to_ell(prows, pcols, pvals, n)
    wp = p_ell_cols.shape[1]
    mc = pvals.shape[2]
    m = avals.shape[1]

    # step 1: AP[i, a] = sum_j A[i,j] P[j, a]   (chunked over A entries)
    pk, pv = [], []
    for s in range(0, arows.size, chunk):
        e = min(s + chunk, arows.size)
        aj = acols[s:e]
        prod = np.matmul(avals[s:e, None], p_ell_vals[aj])  # [c, wp, m, mc]
        keys = (
            arows[s:e, None] * np.int64(n_agg) + p_ell_cols[aj].astype(np.int64)
        ).reshape(-1)
        k, v = _reduce_block_coo(keys, prod.reshape(-1, m, mc))
        pk.append(k)
        pv.append(v)
    apk, apv = _reduce_block_coo(np.concatenate(pk), np.concatenate(pv))
    ap_rows = (apk // n_agg).astype(np.int64)
    ap_cols = (apk % n_agg).astype(np.int64)
    ap_ell_cols, ap_ell_vals = _coo_to_ell(ap_rows, ap_cols, apv, n)
    wap = ap_ell_cols.shape[1]

    # step 2: (P^T AP)[b, a] = sum_i P[i,b]^T AP[i,a]  (chunked over rows)
    pk, pv = [], []
    row_chunk = max(chunk // max(wp * wap, 1), 1)
    for s in range(0, n, row_chunk):
        e = min(s + row_chunk, n)
        prod = np.matmul(
            p_ell_vals[s:e].transpose(0, 1, 3, 2)[:, :, None],
            ap_ell_vals[s:e, None],
        )  # [c, wp, wap, mc, mc]
        keys = (
            p_ell_cols[s:e, :, None].astype(np.int64) * n_agg
            + ap_ell_cols[s:e, None, :].astype(np.int64)
        ).reshape(-1)
        k, v = _reduce_block_coo(keys, prod.reshape(-1, mc, mc))
        pk.append(k)
        pv.append(v)
    ck, cv = _reduce_block_coo(np.concatenate(pk), np.concatenate(pv))
    if not filter_zeros:
        return (
            (ck // n_agg).astype(np.int64),
            (ck % n_agg).astype(np.int64),
            cv,
        )
    return _rap_filter(ck, cv, n_agg)


def _rap_filter(ck, cv, n_agg):
    """Drop numerically-zero fill (padding products, cancellations) to keep
    the coarse ELL width tight; diagonal blocks always survive."""
    norms = np.abs(cv).reshape(cv.shape[0], -1).max(axis=1)
    cutoff = 1e-14 * (norms.max() if norms.size else 1.0)
    keep = norms > cutoff
    keep |= (ck // n_agg) == (ck % n_agg)
    ck, cv = ck[keep], cv[keep]
    return (
        (ck // n_agg).astype(np.int64),
        (ck % n_agg).astype(np.int64),
        cv,
    )


def mesh_state_hash(coords, tris, free) -> str:
    """sha1 identity of the mesh + BC free mask (the expensive part of any
    cache fingerprint: ~0.3 s over ~60 MB at 1M elements). Computed once
    per compile and shared by the AMG-hierarchy and assembled-operator
    cache checks."""
    import hashlib

    h = hashlib.sha1()
    h.update(np.int64(coords.shape[0]).tobytes())
    h.update(np.int64(tris.shape[0]).tobytes())
    h.update(np.ascontiguousarray(coords, np.float64).tobytes())
    h.update(np.ascontiguousarray(tris, np.int64).tobytes())
    h.update(np.ascontiguousarray(free, np.float64).tobytes())
    return h.hexdigest()


def setup_fingerprint(
    coords, tris, free, e_mod, nu, t, cell_factor, mesh_hash=None
) -> str:
    """Exact identity of everything a hierarchy build depends on: the full
    mesh bytes (renumbering changes them; a deterministic re-renumber of
    the same mesh reproduces them), the BC free mask, the material, and
    the aggregation cell factor. Pass a precomputed `mesh_hash`
    (mesh_state_hash) to skip re-hashing the mesh arrays."""
    import hashlib

    if mesh_hash is None:
        mesh_hash = mesh_state_hash(coords, tris, free)
    h = hashlib.sha1()
    h.update(mesh_hash.encode())
    h.update(np.asarray([e_mod, nu, t, cell_factor], np.float64).tobytes())
    return h.hexdigest()


def setup_matches(
    setup, coords, tris, free, metadata, cell_factor, perm, mesh_hash=None
) -> bool:
    """Is a provided AMGSetup valid for THIS problem (post-renumber mesh,
    BC mask, material, aggregation size)? Fingerprint-less caches from
    older saves fall back to a conservative check (no renumbering, same
    node count). The one validity rule shared by compile_problem and the
    sharded prepare -- a mismatched-but-SPD hierarchy would silently cost
    orders of magnitude in iterations. `mesh_hash`: optional precomputed
    mesh_state_hash of (coords, tris, free) to skip the ~0.3 s re-hash."""
    if setup.fingerprint is not None:
        return setup.fingerprint == setup_fingerprint(
            coords,
            tris,
            free,
            metadata.youngs_modulus,
            metadata.poisson_ratio,
            metadata.part_thickness,
            cell_factor,
            mesh_hash=mesh_hash,
        )
    return perm is None and setup.level_sizes[0][0] == coords.shape[0]


@dataclass
class AMGSetup:
    """Host-side hierarchy. Level 0's operator is NOT stored (the solver
    injects its fast reduced matvec); levels >= 1 carry block-ELL operators.

    `fingerprint` identifies the exact (mesh, node ordering) the hierarchy
    was built for (None on caches saved before it existed).

    transfers[l]: (p_cols [n_l, wp], p_vals [n_l, wp, m_l, m_{l+1}],
                   pt_cols [n_{l+1}, wr], pt_vals [n_{l+1}, wr, m_{l+1}, m_l])
    coarse_ops[l-1] for l >= 1: (a_cols [n_l, w], a_vals [n_l, w, m, m],
                                 diag_inv [n_l, m, m])
    coarsest_inv: dense pseudo-inverse of the last level (or None).

    fast0: gather-light FACTORED form of the level-0 transfer, or None.
    P = (I - omega D^-1 A) P0 is never materialized at level 0 by the
    device V-cycle when this is present; instead P/P^T applies ride the
    solver's fast band matvec (see make_amg_preconditioner). Contents:
      (agg [n0] int32            -- aggregate id per fine node,
       p0_block [n0, 2, 3]       -- each node's single tentative block,
       pt0_cols [n1, w0] int32   -- member fine nodes per aggregate (ELL),
       pt0_vals [n1, w0, 3, 2]   -- transposed tentative blocks,
       dinv0w [n0, 2, 2]         -- omega * D^-1 (smoothing pre-folded)).
    """

    transfers: list
    coarse_ops: list
    coarsest_inv: Optional[np.ndarray]
    level_sizes: list  # [(n_l, m_l)]
    setup_info: dict
    fingerprint: Optional[str] = None
    fast0: Optional[tuple] = None


def _fast0_arrays(agg, p0_block, diag_inv, omega, n_agg):
    """Factored level-0 transfer arrays (see AMGSetup.fast0).

    P0^T is stored as a tiny ELL over COARSE rows (width = max aggregate
    size, bounded by _MAX_AGG_SIZE) so the device restriction is a gather
    of the fine residual instead of a scatter."""
    n = p0_block.shape[0]
    counts = np.bincount(agg, minlength=n_agg)
    w0 = max(int(counts.max()) if counts.size else 1, 1)
    order = np.argsort(agg, kind="stable")
    starts = np.searchsorted(agg[order], np.arange(n_agg))
    ranks = np.empty(n, dtype=np.int64)
    ranks[order] = np.arange(n) - starts[agg[order]]
    pt0_cols = np.zeros((n_agg, w0), dtype=np.int32)
    pt0_vals = np.zeros((n_agg, w0, 3, 2))
    pt0_cols[agg, ranks] = np.arange(n, dtype=np.int32)
    pt0_vals[agg, ranks] = p0_block.transpose(0, 2, 1)
    return (
        agg.astype(np.int32),
        np.ascontiguousarray(p0_block),
        pt0_cols,
        pt0_vals,
        omega * diag_inv,
    )


def build_amg_setup(
    coords: np.ndarray,
    tris: np.ndarray,
    e_mod: float,
    nu: float,
    t: float,
    free: np.ndarray,  # [N, 2] float or bool, 1 = unknown DOF
    *,
    cell_factor: float = 3.0,
    max_levels: int = 8,
    coarse_dof: int = _DENSE_COARSE_MAX_DOF,
    mesh_hash: Optional[str] = None,
) -> AMGSetup:
    """Build the SA hierarchy for one mesh + BC set (host, numpy)."""
    coords = np.asarray(coords, dtype=np.float64)
    free = np.asarray(free, dtype=np.float64)
    n = coords.shape[0]

    rows, cols, vals = _assemble_block_coo(
        coords, tris, float(e_mod), float(nu), float(t), free
    )

    # rigid-body near-nullspace, zeroed at fixed DOFs; coordinates centered
    # for conditioning of the per-aggregate QR
    c0 = coords - coords.mean(axis=0)
    bmodes = np.zeros((n, 2, 3))
    bmodes[:, 0, 0] = 1.0
    bmodes[:, 1, 1] = 1.0
    bmodes[:, 0, 2] = -c0[:, 1]
    bmodes[:, 1, 2] = c0[:, 0]
    bmodes *= free[:, :, None]

    p = coords[tris]
    h = float(
        np.median(
            np.concatenate(
                [
                    np.hypot(*(p[:, 0] - p[:, 1]).T),
                    np.hypot(*(p[:, 1] - p[:, 2]).T),
                    np.hypot(*(p[:, 2] - p[:, 0]).T),
                ]
            )
        )
    )
    cell = cell_factor * h

    transfers = []
    coarse_ops = []
    level_sizes = [(n, 2)]
    cur_coords = coords
    m = 2
    info = {"omegas": [], "rhos": []}
    fast0 = None

    while len(level_sizes) < max_levels and level_sizes[-1][0] * m > coarse_dof:
        n_l = level_sizes[-1][0]
        agg, centroids = _aggregate_cells(cur_coords, cell)
        n_agg = centroids.shape[0]
        if n_agg * 3 >= n_l * m:  # coarsening stalled; stop here
            break
        p0_block, b_coarse = _tentative_prolongator(agg, n_agg, bmodes)
        diag_inv = _guarded_inverse(_diag_blocks(rows, cols, vals, n_l))
        rho = _estimate_rho_dinv_a(rows, cols, vals, diag_inv, n_l)
        omega = 4.0 / 3.0 / max(rho, 1e-12)
        info["rhos"].append(rho)
        info["omegas"].append(omega)
        if len(level_sizes) == 1:
            fast0 = _fast0_arrays(agg, p0_block, diag_inv, omega, n_agg)
        prows, pcols, pvals = _smooth_prolongator(
            rows, cols, vals, diag_inv, agg, p0_block, n_agg, omega
        )
        p_cols, p_vals = _coo_to_ell(prows, pcols, pvals, n_l)
        # P^T in ELL by coarse row: transpose the COO and re-sort
        tk, tv = _reduce_block_coo(
            pcols * np.int64(n_l) + prows, pvals.transpose(0, 2, 1)
        )
        pt_cols, pt_vals = _coo_to_ell(
            (tk // n_l).astype(np.int64), (tk % n_l).astype(np.int64), tv, n_agg
        )
        transfers.append((p_cols, p_vals, pt_cols, pt_vals))

        rows, cols, vals = _rap(
            rows, cols, vals, prows, pcols, pvals, n_agg, n_rows=n_l
        )
        a_cols, a_vals = _coo_to_ell(rows, cols, vals, n_agg)
        d_inv = _guarded_inverse(_diag_blocks(rows, cols, vals, n_agg))
        coarse_ops.append((a_cols, a_vals, d_inv))

        bmodes = b_coarse
        cur_coords = centroids
        m = 3
        level_sizes.append((n_agg, m))
        cell *= cell_factor

    coarsest_inv = None
    nl, ml = level_sizes[-1]
    # also when the mesh never coarsened (tiny meshes, n*2 <= coarse_dof):
    # rows/cols/vals then hold the level-0 BC-masked assembly and the
    # "hierarchy" is one exact dense inverse -- CG converges in ~2
    # iterations instead of the O(1/h) block-Jacobi counts
    # (make_amg_preconditioner's single-level ci branch)
    if nl * ml <= coarse_dof:
        dense = np.zeros((nl, ml, nl, ml))
        dense[rows, :, cols, :] = vals
        dense = dense.reshape(nl * ml, nl * ml)
        # degenerate coarse DOFs (fully-constrained/empty aggregates) have
        # ~zero rows; invert the ACTIVE submatrix and leave those DOFs at
        # exactly 0 -- matching _guarded_inverse semantics. (A jittered
        # full inverse would carry ~1/jitter-scale entries there, which
        # amplify f32 V-cycle roundoff instead of annihilating it.)
        diag = np.diagonal(dense)
        active = diag > 1e-12 * max(float(diag.max()), 1e-300)
        coarsest_inv = np.zeros_like(dense)
        try:
            # SPD block: Cholesky-based inversion (potrf+potri) is ~2x
            # np.linalg.inv's LU path at the ~1.5k-DOF coarse size
            from scipy.linalg.lapack import dpotrf, dpotri

            sub = dense[np.ix_(active, active)]
            chol, rc = dpotrf(sub, lower=1, overwrite_a=0)
            if rc != 0:
                raise np.linalg.LinAlgError
            inv, rc = dpotri(chol, lower=1)
            if rc != 0:
                raise np.linalg.LinAlgError
            # dpotri fills one triangle; mirror it
            inv = np.tril(inv) + np.tril(inv, -1).T
            coarsest_inv[np.ix_(active, active)] = inv
        except (np.linalg.LinAlgError, ImportError):
            try:
                coarsest_inv[np.ix_(active, active)] = np.linalg.inv(
                    dense[np.ix_(active, active)]
                )
            except np.linalg.LinAlgError:
                # truly singular active block: iterative smoothing instead
                coarsest_inv = None

    info["levels"] = level_sizes
    return AMGSetup(
        transfers=transfers,
        coarse_ops=coarse_ops,
        coarsest_inv=coarsest_inv,
        level_sizes=level_sizes,
        setup_info=info,
        fingerprint=setup_fingerprint(
            coords, tris, free, float(e_mod), float(nu), float(t),
            float(cell_factor), mesh_hash=mesh_hash,
        ),
        fast0=fast0,
    )


# ------------------- material-basis hierarchy (sweeps) ----------------------
#
# True (E, nu, t) material sweeps on unstructured meshes: the plane-stress
# D matrix is linear in (d0, d1, d2), so THREE basis stiffness operators
# (unit d0 / d1 / d2, t = 1) span every material:
#     K(E, nu, t) = wa*Ka + wb*Kb + wc*Kc,
#     wa = t*E/(1-nu^2), wb = nu*wa, wc = (1-nu)/2*wa.
# Transfers P are built ONCE at a reference material (P quality only
# affects preconditioner efficiency, never correctness), and the Galerkin
# product is linear in A, so RAP-ing each basis with the same P carries the
# decomposition down every level EXACTLY: each lane's coarse operator is
# wa*PtAaP + wb*PtAbP + wc*PtAcP. Per-lane diagonal-block inverses are
# formed on the fly in the lane smoother (parallel/sweep.py).

_UNIT_DCOEFS = ((1.0, 0.0, 0.0), (0.0, 1.0, 0.0), (0.0, 0.0, 1.0))


@dataclass
class AMGMaterialSetup:
    """Basis-decomposed hierarchy for material-lane sweeps.

    transfers: as AMGSetup (shared by all bases).
    coarse_basis[l] for coarse level l: (a_cols [n,w],
        (av_a, av_b, av_c) each [n, w, m, m] basis operator values on ONE
        shared pattern, (d_a, d_b, d_c) each [n, m, m] basis diagonals).
    No dense coarsest inverse (it would be material-dependent); the
    coarsest level smooths.
    """

    transfers: list
    coarse_basis: list
    level_sizes: list
    setup_info: dict
    fingerprint: Optional[str] = None


def build_amg_material_setup(
    coords: np.ndarray,
    tris: np.ndarray,
    free: np.ndarray,  # [N, 2] float or bool, 1 = unknown DOF
    *,
    nu_ref: float = 0.3,
    cell_factor: float = 3.0,
    max_levels: int = 8,
    coarse_dof: int = _DENSE_COARSE_MAX_DOF,
) -> AMGMaterialSetup:
    """Build the shared-transfer basis hierarchy (host, numpy).

    `nu_ref` fixes the reference material for prolongator smoothing and
    aggregation; absolute stiffness scale cancels (rho(D^-1 A) is
    scale-invariant), so only the Poisson ratio matters and mild lane
    deviations cost a few extra CG iterations, never correctness."""
    coords = np.asarray(coords, dtype=np.float64)
    free = np.asarray(free, dtype=np.float64)
    n = coords.shape[0]

    triples = [
        _assemble_block_coo(coords, tris, 0.0, 0.0, 1.0, free, dcoefs=dc)
        for dc in _UNIT_DCOEFS
    ]
    rows, cols = triples[0][0], triples[0][1]
    vals3 = [t[2] for t in triples]
    d0r = 1.0 / (1.0 - nu_ref * nu_ref)
    wref = (d0r, nu_ref * d0r, 0.5 * (1.0 - nu_ref) * d0r)

    c0 = coords - coords.mean(axis=0)
    bmodes = np.zeros((n, 2, 3))
    bmodes[:, 0, 0] = 1.0
    bmodes[:, 1, 1] = 1.0
    bmodes[:, 0, 2] = -c0[:, 1]
    bmodes[:, 1, 2] = c0[:, 0]
    bmodes *= free[:, :, None]

    p = coords[tris]
    h = float(
        np.median(
            np.concatenate(
                [
                    np.hypot(*(p[:, 0] - p[:, 1]).T),
                    np.hypot(*(p[:, 1] - p[:, 2]).T),
                    np.hypot(*(p[:, 2] - p[:, 0]).T),
                ]
            )
        )
    )
    cell = cell_factor * h

    transfers = []
    coarse_basis = []
    level_sizes = [(n, 2)]
    cur_coords = coords
    m = 2
    info = {"omegas": [], "rhos": []}

    while len(level_sizes) < max_levels and level_sizes[-1][0] * m > coarse_dof:
        n_l = level_sizes[-1][0]
        vals_ref = wref[0] * vals3[0] + wref[1] * vals3[1] + wref[2] * vals3[2]
        agg, centroids = _aggregate_cells(cur_coords, cell)
        n_agg = centroids.shape[0]
        if n_agg * 3 >= n_l * m:
            break
        p0_block, b_coarse = _tentative_prolongator(agg, n_agg, bmodes)
        diag_inv = _guarded_inverse(_diag_blocks(rows, cols, vals_ref, n_l))
        rho = _estimate_rho_dinv_a(rows, cols, vals_ref, diag_inv, n_l)
        omega = 4.0 / 3.0 / max(rho, 1e-12)
        info["rhos"].append(rho)
        info["omegas"].append(omega)
        prows, pcols, pvals = _smooth_prolongator(
            rows, cols, vals_ref, diag_inv, agg, p0_block, n_agg, omega
        )
        p_cols, p_vals = _coo_to_ell(prows, pcols, pvals, n_l)
        tk, tv = _reduce_block_coo(
            pcols * np.int64(n_l) + prows, pvals.transpose(0, 2, 1)
        )
        pt_cols, pt_vals = _coo_to_ell(
            (tk // n_l).astype(np.int64), (tk % n_l).astype(np.int64), tv, n_agg
        )
        transfers.append((p_cols, p_vals, pt_cols, pt_vals))

        # basis RAPs on ONE shared pattern (filtering on combined norms)
        raps = [
            _rap(
                rows, cols, v, prows, pcols, pvals, n_agg, n_rows=n_l,
                filter_zeros=False,
            )
            for v in vals3
        ]
        crows, ccols = raps[0][0], raps[0][1]
        for r2, c2, _ in raps[1:]:
            assert np.array_equal(crows, r2) and np.array_equal(ccols, c2)
        cvals3 = [r[2] for r in raps]
        comb = wref[0] * cvals3[0] + wref[1] * cvals3[1] + wref[2] * cvals3[2]
        norms = np.abs(comb).reshape(comb.shape[0], -1).max(axis=1)
        keep = norms > 1e-14 * (norms.max() if norms.size else 1.0)
        keep |= crows == ccols
        rows, cols = crows[keep], ccols[keep]
        vals3 = [v[keep] for v in cvals3]

        a_cols = None
        a_vals3 = []
        diag3 = []
        for v in vals3:
            ac, av = _coo_to_ell(rows, cols, v, n_agg)
            a_cols = ac
            a_vals3.append(av)
            diag3.append(_diag_blocks(rows, cols, v, n_agg))
        # bases stay SEPARATE arrays, one per basis weight of the sweep
        coarse_basis.append(
            (a_cols, tuple(a_vals3), tuple(diag3))
        )

        bmodes = b_coarse
        cur_coords = centroids
        m = 3
        level_sizes.append((n_agg, m))
        cell *= cell_factor

    info["levels"] = level_sizes
    return AMGMaterialSetup(
        transfers=transfers,
        coarse_basis=coarse_basis,
        level_sizes=level_sizes,
        setup_info=info,
        fingerprint=setup_fingerprint(
            coords, tris, free, 0.0, float(nu_ref), 1.0, float(cell_factor)
        ),
    )


def material_amg_device_arrays(setup: AMGMaterialSetup, dtype) -> tuple:
    """Upload the basis hierarchy as a jit-traceable pytree."""
    transfers = tuple(
        (
            jnp.asarray(pc),
            jnp.asarray(pv, dtype=dtype),
            jnp.asarray(tc),
            jnp.asarray(tv, dtype=dtype),
        )
        for pc, pv, tc, tv in setup.transfers
    )
    coarse = tuple(
        (
            jnp.asarray(ac),
            tuple(jnp.asarray(a, dtype=dtype) for a in av3),
            tuple(jnp.asarray(d, dtype=dtype) for d in d3),
        )
        for ac, av3, d3 in setup.coarse_basis
    )
    return (transfers, coarse)


def amg_device_arrays(setup: AMGSetup, dtype, lanes: bool = False) -> tuple:
    """Upload the hierarchy as a jit-traceable pytree of device arrays:
    (transfers, coarse, ci, fast0, coarse_bands) -- fast0 is () when the
    setup predates the factored transfer (old persisted caches).

    coarse_bands[l] is a BandedOp (DIA form of coarse_ops[l], derived here
    from the ELL arrays -- persisted caches need no new format) or None
    when the coarse graph is band-hostile; make_coarse_cycle smooths on
    bands when present (streaming rolls) instead of the gather ELL.

    When fast0 is present, the level-0 smoothed transfer ELL pair (by far
    the largest hierarchy arrays AND the V-cycle's dominant cost as
    gathers) is neither uploaded nor applied -- the V-cycle uses the
    factored form (see make_amg_preconditioner).

    `lanes` declares the consumer: lane-batched sweep V-cycles (True) run
    coarse smoothing on the gather ELL (the lane axis broadcasts through
    the gather) and never touch the DIA bands; single-vector solves
    (False) smooth on the bands and never touch the ELL values of banded
    levels. Each mode uploads only what it applies -- the other form gets
    zero-size placeholders (the coarse operator otherwise ships twice,
    up to _COARSE_MAX_DIAGS*m*m*n_l floats per level).

    All arrays ride one `packed_device_put`."""
    from ..utils.transfer import packed_device_put

    def _cast(a, dt):
        a = np.asarray(a)
        return a.astype(dt) if dt is not None and a.dtype != dt else a

    skip0 = setup.fast0 is not None and len(setup.transfers) > 0

    band_specs = [
        None if lanes else _ell_to_bands(ac, av)
        for ac, av, _ in setup.coarse_ops
    ]
    # single-vector consumers smooth banded levels on the bands; their
    # ELL form would be dead weight in device memory
    skip_ell = [spec is not None for spec in band_specs]

    host: list = []
    for l, (pc, pv, tc, tv) in enumerate(setup.transfers):
        if skip0 and l == 0:
            continue
        host += [_cast(pc, None), _cast(pv, dtype), _cast(tc, None), _cast(tv, dtype)]
    for (ac, av, di), skip in zip(setup.coarse_ops, skip_ell):
        if skip:
            host.append(_cast(di, dtype))
        else:
            host += [_cast(ac, None), _cast(av, dtype), _cast(di, dtype)]
    for spec in band_specs:
        if spec is not None:
            host.append(_cast(spec[1], dtype))
    if setup.coarsest_inv is not None:
        host.append(_cast(setup.coarsest_inv, dtype))
    if setup.fast0 is not None:
        agg, p0, ptc, ptv, dw = setup.fast0
        host += [
            _cast(agg, None), _cast(p0, dtype), _cast(ptc, None),
            _cast(ptv, dtype), _cast(dw, dtype),
        ]

    dev = packed_device_put(host)
    it = iter(dev)
    transfers = []
    for l in range(len(setup.transfers)):
        if skip0 and l == 0:
            # placeholder with the right pytree arity; never applied
            z = jnp.zeros((0,), dtype=jnp.int32)
            zv = jnp.zeros((0,), dtype=dtype)
            transfers.append((z, zv, z, zv))
        else:
            transfers.append((next(it), next(it), next(it), next(it)))
    coarse = []
    for skip in skip_ell:
        if skip:
            coarse.append(
                (
                    jnp.zeros((0, 0), dtype=jnp.int32),
                    jnp.zeros((0,), dtype=dtype),
                    next(it),
                )
            )
        else:
            coarse.append((next(it), next(it), next(it)))
    coarse = tuple(coarse)
    coarse_bands = tuple(
        BandedOp(next(it), spec[0]) if spec is not None else None
        for spec in band_specs
    )
    ci = (next(it),) if setup.coarsest_inv is not None else ()
    fast0: tuple = ()
    if setup.fast0 is not None:
        fast0 = (next(it), next(it), next(it), next(it), next(it))
    return (tuple(transfers), coarse, ci, fast0, coarse_bands)


# =========================== device V-cycle =================================


# distinct (col - row) offsets a coarse level may use before falling back
# to the gather ELL path; bands cost D*m*m*n floats of HBM, so a cap keeps
# pathological (band-hostile) coarse graphs from exploding the upload
_COARSE_MAX_DIAGS = 80


def _ell_to_bands(a_cols, a_vals, max_diags: int = _COARSE_MAX_DIAGS):
    """Block-ELL -> (offsets, DIA bands [D, m, m, n]), or None if the
    graph needs more than max_diags distinct (col - row) offsets.

    Aggregate ids are spatially row-major (_aggregate_cells keys cells by
    iy*nx+ix), so coarse graphs inherit the fine level's bandedness; the
    gather-bound ELL matvec then has a rolls-only DIA equivalent that
    streams with no index arrays (fem/dia.py).
    Zero blocks (ELL padding sits at col 0) are dropped -- they contribute
    nothing and would otherwise smear padding offsets into the band set.
    """
    n, w = a_cols.shape[:2]
    m = a_vals.shape[2]
    rows = np.arange(n, dtype=np.int64)[:, None]
    offs = a_cols.astype(np.int64) - rows
    nz = np.abs(a_vals).reshape(n, w, -1).max(axis=2) > 0.0
    uniq = np.unique(offs[nz])
    if uniq.size == 0 or uniq.size > max_diags:
        return None
    bands = np.zeros((uniq.size, m, m, n), dtype=a_vals.dtype)
    d_idx = np.searchsorted(uniq, offs[nz])
    r_idx = np.broadcast_to(rows, offs.shape)[nz]
    # add.at, not assignment: nothing above guarantees (row, col) slots
    # are unique in the ELL
    np.add.at(bands, (d_idx, slice(None), slice(None), r_idx), a_vals[nz])
    return tuple(int(o) for o in uniq), bands


@jax.tree_util.register_pytree_node_class
class BandedOp:
    """A DIA operator riding a jit argument pytree: the band array is a
    traced leaf, the offset tuple lives in the treedef (static), so the
    roll lowering sees compile-time offsets without embedding the
    (large) bands as HLO constants."""

    __slots__ = ("bands", "offsets")

    def __init__(self, bands, offsets: tuple[int, ...]):
        self.bands = bands
        self.offsets = tuple(int(o) for o in offsets)

    def tree_flatten(self):
        return (self.bands,), self.offsets

    @classmethod
    def tree_unflatten(cls, offsets, children):
        obj = cls.__new__(cls)
        obj.bands = children[0]
        obj.offsets = offsets
        return obj


def _block_ell_matvec(a_cols, a_vals, x):
    """x [n, m] (or lane-batched [n, m, B]) -> same shape, via gather +
    block contraction. The lane axis stays minormost so the sweep layout
    ([.., B]) broadcasts through every level of the hierarchy."""
    if x.ndim == 3:
        return jnp.einsum(
            "nwij,nwjb->nib", a_vals, x[a_cols], precision="highest"
        )
    return jnp.einsum(
        "nwij,nwj->ni", a_vals, x[a_cols], precision="highest"
    )


def _apply_blocks(blocks, x):
    if x.ndim == 3:
        return jnp.einsum("nij,njb->nib", blocks, x, precision="highest")
    return jnp.einsum("nij,nj->ni", blocks, x, precision="highest")


def amg_sweep_schedule(mixed_precision: bool, override: int = 0) -> int:
    """Pre/post smoothing sweeps per V-cycle (SolverOptions.amg_sweeps).

    The single source of the schedule policy -- every AMG-preconditioned
    path (fem/solve, parallel/dia_shard, parallel/sweep) derives its
    V(s,s) from here. ``override > 0`` pins an explicit schedule. Auto:

    - V(3,3) when a cheap f32 V-cycle preconditions rtol-terminated f64
      CG (``mixed_precision=True``): extra f32 sweeps cut the f64
      iteration count (19 -> 12 at 23k nodes). This was tuned where f64
      was emulated in f32 pairs; with the H100's native f64 the trade
      is re-decided from measurements (ROADMAP S4).
    - V(1,1) for same-precision V-cycles: each sweep pays full price,
      where fewer iterations no longer cover the added cost.

    Fixed-iteration-budget callers (the lane-sweep cores) must pass
    ``mixed_precision=False``: a static budget cannot harvest an
    iteration cut, so extra sweeps are pure added cost per solve unless
    the caller also shrinks its budget (which ``override`` enables)."""
    if override > 0:
        return int(override)
    return 3 if mixed_precision else 1


def make_amg_preconditioner(
    amg: tuple,
    op0: MatVec,
    jac0: MatVec,
    *,
    layout: str = "t",
    pre_sweeps: int = 1,
    post_sweeps: int = 1,
    omega0: float = 0.7,
    omega: float = 0.7,
    coarse_sweeps: int = 24,
    a_op: Optional[MatVec] = None,
    coarse_level_sweeps: Optional[int] = None,
) -> MatVec:
    """V(1,1)-cycle apply(r) ~= A^-1 r.

    amg: pytree from `amg_device_arrays`. op0/jac0: the solver's REDUCED
    level-0 operator and block-Jacobi-inverse apply, in the layout given by
    `layout` ("t" = [2, N] band layout used by DIA/hybrid, "n" = [N, 2]
    node-major ELL layout, "tl" = [2, N, B] lane-batched band layout used
    by design sweeps -- ONE hierarchy preconditions every lane, with the
    lane axis broadcast minormost through all levels). Transfers and coarse
    levels always run node-major.

    a_op: the UNSHIFTED masked operator A = free * K * free in the same
    layout (op0 minus its identity-on-constrained part). Required when the
    hierarchy carries factored level-0 transfers (AMGSetup.fast0): the
    smoothed prolongator P = (I - omega D^-1 A) P0 is then applied as that
    composition -- two extra band matvecs replace the giant level-0 ELL
    gather pair, which is by far the largest array of the hierarchy
    (scripts/profile_unstructured.py times both forms). P^T rides the
    mirrored composition P^T r = P0^T (r - A (omega D^-1) r), so the pair stays an exact
    adjoint and the V-cycle remains a valid SPD preconditioner.
    """
    coarse_bands = ()
    if len(amg) == 5:
        transfers, coarse, ci, fast0, coarse_bands = amg
    elif len(amg) == 4:
        transfers, coarse, ci, fast0 = amg
    else:
        transfers, coarse, ci = amg
        fast0 = ()
    n_levels = len(transfers) + 1
    if fast0 and n_levels > 1 and a_op is None:
        raise ValueError(
            "this AMG pytree carries factored level-0 transfers "
            "(the stored ELL pair was not uploaded); pass a_op= the "
            "masked operator free*K*free in the level-0 layout"
        )
    use_fast = bool(fast0) and n_levels > 1 and a_op is not None

    def to_nodes(r):
        if layout == "tl":
            return r.transpose(1, 0, 2)
        return r.T if layout == "t" else r

    def from_nodes(r):
        if layout == "tl":
            return r.transpose(1, 0, 2)
        return r.T if layout == "t" else r

    # Below the fine level the smoothing sweeps run on gather-bound
    # block-ELL operators; extra sweeps there buy far less convergence
    # per ms than the fine level's band-matvec sweeps (the V(3,3)
    # schedule exists to cut expensive f64 CG iterations -- a fine-level
    # tradeoff). Coarse levels default to V(1,1) unless pinned.
    cls = 1 if coarse_level_sweeps is None else int(coarse_level_sweeps)
    cycle = make_coarse_cycle(
        transfers[1:],
        coarse,
        ci,
        pre_sweeps=cls,
        post_sweeps=cls,
        omega=omega,
        coarse_sweeps=coarse_sweeps,
        coarse_bands=coarse_bands,
    )

    if use_fast:
        agg, p0, pt0_cols, pt0_vals, dinv0w = fast0

        hp = {"precision": "highest"}

        def dinv_apply(v):  # omega * D^-1 in the level-0 layout
            if layout == "n":
                return jnp.einsum("nij,nj->ni", dinv0w, v, **hp)
            if layout == "tl":
                return jnp.einsum("nij,jnb->inb", dinv0w, v, **hp)
            return jnp.einsum("nij,jn->in", dinv0w, v, **hp)

        def restrict(res):  # P^T res in level-0 layout -> [n1, 3(, B)]
            tmp = res - a_op(dinv_apply(res))
            if layout == "n":
                return jnp.einsum(
                    "nwij,nwj->ni", pt0_vals, tmp[pt0_cols], **hp
                )
            if layout == "tl":
                return jnp.einsum(
                    "nwij,jnwb->nib", pt0_vals, tmp[:, pt0_cols], **hp
                )
            return jnp.einsum(
                "nwij,jnw->ni", pt0_vals, tmp[:, pt0_cols], **hp
            )

        def prolong(ec):  # P ec -> correction in level-0 layout
            if layout == "tl":
                uf = from_nodes(
                    jnp.einsum("nij,njb->nib", p0, ec[agg], **hp)
                )
            else:
                uf = from_nodes(jnp.einsum("nij,nj->ni", p0, ec[agg], **hp))
            return uf - dinv_apply(a_op(uf))

    def apply(r):
        # level 0 on the injected fast operator, in its native layout
        if n_levels == 1:
            if ci:
                # single-level hierarchy with a dense inverse (small
                # problems that never coarsened): exact preconditioner
                rn = to_nodes(r)
                flat = rn.reshape(rn.shape[0] * rn.shape[1], -1)
                return from_nodes(
                    jnp.matmul(ci[0], flat, precision="highest").reshape(
                        rn.shape
                    )
                )
            return omega0 * jac0(r)
        e = omega0 * jac0(r)
        for _ in range(pre_sweeps - 1):
            e = e + omega0 * jac0(r - op0(e))
        res = r - op0(e)
        if use_fast:
            rc = restrict(res)
            ec = cycle(0, rc)
            e = e + prolong(ec)
        else:
            p_cols, p_vals, pt_cols, pt_vals = transfers[0]
            rc = _block_ell_matvec(pt_cols, pt_vals, to_nodes(res))
            ec = cycle(0, rc)
            e = e + from_nodes(_block_ell_matvec(p_cols, p_vals, ec))
        for _ in range(post_sweeps):
            e = e + omega0 * jac0(r - op0(e))
        return e

    return apply


def make_coarse_cycle(
    transfers_tail: tuple,
    coarse: tuple,
    ci: tuple,
    *,
    pre_sweeps: int = 1,
    post_sweeps: int = 1,
    omega: float = 0.7,
    coarse_sweeps: int = 24,
    coarse_bands: tuple = (),
):
    """The replicated part of the V-cycle, below the fine level.

    cycle(l, r): r [n_{l+1}, m] node-major at coarse index l (0 = the first
    coarse level); transfers_tail[l] connects coarse levels l and l+1.
    Shared by the single-device preconditioner and the sharded solvers
    (parallel/dia_shard.py), so smoothing schedules and the dense-coarsest
    branch cannot drift apart.

    coarse_bands[l] (a BandedOp, or None) replaces the level's gather-ELL
    matvec with the DIA roll formulation for plain [n, m] operands;
    lane-batched [n, m, B] sweeps keep the ELL gather (its lane axis
    broadcasts through the gather for free, and sweep meshes are small).
    """
    n_coarse = len(coarse)

    def _matvec(l, x):
        cb = coarse_bands[l] if l < len(coarse_bands) else None
        if cb is not None and x.ndim == 2:
            from .dia import make_dia_operator

            return make_dia_operator(cb.bands, cb.offsets)(x.T).T
        a_cols, a_vals, _ = coarse[l]
        return _block_ell_matvec(a_cols, a_vals, x)

    def smooth(l, e, r, sweeps):
        d_inv = coarse[l][2]
        for _ in range(sweeps):
            res = r - _matvec(l, e)
            e = e + omega * _apply_blocks(d_inv, res)
        return e

    def cycle(l, r):
        if l == n_coarse - 1:
            if ci:
                # precision="highest": a reduced-precision default (TF32
                # on the GPU) gives a ~1e-2-noise coarse correction, which
                # stalled lane sweeps at 1e-2 relative; full f32 costs
                # microseconds at coarsest sizes
                flat = r.reshape(r.shape[0] * r.shape[1], -1)
                return jnp.matmul(
                    ci[0], flat, precision="highest"
                ).reshape(r.shape)
            return smooth(l, jnp.zeros_like(r), r, coarse_sweeps)
        d_inv = coarse[l][2]
        e = omega * _apply_blocks(d_inv, r)
        e = smooth(l, e, r, pre_sweeps - 1)
        res = r - _matvec(l, e)
        tp_cols, tp_vals, tpt_cols, tpt_vals = transfers_tail[l]
        rc = _block_ell_matvec(tpt_cols, tpt_vals, res)
        ec = cycle(l + 1, rc)
        e = e + _block_ell_matvec(tp_cols, tp_vals, ec)
        return smooth(l, e, r, post_sweeps)

    return cycle


# ============================ persistence ===================================


def setup_to_arrays(setup: AMGSetup) -> dict:
    """Flatten an AMGSetup into a {name: array} dict (npz-friendly).

    The hierarchy build is the dominant host cost for large unstructured
    meshes (~50 s at 1M elements on one core); persisting it with the case
    checkpoint makes re-runs start solving immediately."""
    out = {
        "amg_n_transfers": np.int64(len(setup.transfers)),
        "amg_level_sizes": np.asarray(setup.level_sizes, dtype=np.int64),
    }
    if setup.fingerprint is not None:
        out["amg_fingerprint"] = np.asarray(setup.fingerprint)
    for l, (pc, pv, tc, tv) in enumerate(setup.transfers):
        out[f"amg_t{l}_pcols"] = pc
        out[f"amg_t{l}_pvals"] = pv
        out[f"amg_t{l}_ptcols"] = tc
        out[f"amg_t{l}_ptvals"] = tv
    for l, (ac, av, di) in enumerate(setup.coarse_ops):
        out[f"amg_c{l}_acols"] = ac
        out[f"amg_c{l}_avals"] = av
        out[f"amg_c{l}_dinv"] = di
    if setup.coarsest_inv is not None:
        out["amg_coarsest_inv"] = setup.coarsest_inv
    if setup.fast0 is not None:
        agg, p0, ptc, ptv, dw = setup.fast0
        out["amg_f0_agg"] = agg
        out["amg_f0_p0"] = p0
        out["amg_f0_ptcols"] = ptc
        out["amg_f0_ptvals"] = ptv
        out["amg_f0_dinvw"] = dw
    return out


def setup_from_arrays(data: dict) -> AMGSetup:
    """Inverse of `setup_to_arrays`."""
    n = int(data["amg_n_transfers"])
    transfers = [
        (
            data[f"amg_t{l}_pcols"],
            data[f"amg_t{l}_pvals"],
            data[f"amg_t{l}_ptcols"],
            data[f"amg_t{l}_ptvals"],
        )
        for l in range(n)
    ]
    coarse = [
        (data[f"amg_c{l}_acols"], data[f"amg_c{l}_avals"], data[f"amg_c{l}_dinv"])
        for l in range(n)
    ]
    sizes = [tuple(int(v) for v in row) for row in data["amg_level_sizes"]]
    fp = data.get("amg_fingerprint")
    fast0 = None
    if "amg_f0_agg" in data:
        fast0 = (
            data["amg_f0_agg"],
            data["amg_f0_p0"],
            data["amg_f0_ptcols"],
            data["amg_f0_ptvals"],
            data["amg_f0_dinvw"],
        )
    return AMGSetup(
        transfers=transfers,
        coarse_ops=coarse,
        coarsest_inv=data.get("amg_coarsest_inv"),
        level_sizes=sizes,
        setup_info={"loaded": True},
        fingerprint=None if fp is None else str(fp),
        fast0=fast0,
    )
