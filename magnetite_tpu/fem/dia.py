"""DIA (diagonal-band) sparse operator: SpMV as shifted reads.

Meshes produced by this framework's generators and its hex-lattice Delaunay
mesher have near-structured connectivity: after node numbering, the offset
``col - row`` of every stored block takes only a handful of distinct values
(7 for a structured rect grid, ~13 for the annulus plate-with-hole including
ring wraps). Storing one band per offset turns SpMV into

    y[i,n] = sum_d sum_j band[d,i,j,n] * u[j, n + offset_d]

-- static rolls + fused multiply-adds over [2, N] vectors with N minormost,
no index arrays: XLA fuses the whole sum into one streaming pass.

Falls back to ELL (operator.py) when a mesh's offset set is too large
(pathological unstructured numbering); `renumber` in meshing.reorder reduces
most meshes to a DIA-friendly offset set.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class DiaStructure:
    """Static band pattern of the global stiffness matrix.

    offsets:  [D] int64, sorted distinct values of (col - row).
    slot_ids: [E*9] int32, destination band*N + row for each element block
              (pair enumeration order matches assembly.element_blocks).
    n_nodes, n_diags: dimensions.
    """

    offsets: np.ndarray
    slot_ids: np.ndarray
    n_nodes: int
    n_diags: int


def build_dia_structure(
    tris: np.ndarray, n_nodes: int, max_diags: int = 48
) -> Optional[DiaStructure]:
    """Build the DIA pattern, or None if the mesh needs > max_diags bands.

    Native C++ builder when available; numpy otherwise.
    """
    from ..native import dia_structure as native_dia

    native = native_dia(np.asarray(tris), int(n_nodes), max_diags)
    if native is False:
        return None
    if native is not None:
        offsets, slot_ids = native
        return DiaStructure(
            offsets=offsets,
            slot_ids=slot_ids,
            n_nodes=int(n_nodes),
            n_diags=int(offsets.size),
        )
    tris = np.asarray(tris, dtype=np.int64)
    e = tris.shape[0]
    rows = np.repeat(tris, 3, axis=1).reshape(-1)  # [E*9] (a-major)
    cols = np.tile(tris, (1, 3)).reshape(-1)
    offs = cols - rows
    uniq = np.unique(offs)
    if uniq.size > max_diags:
        return None
    d_idx = np.searchsorted(uniq, offs)
    slot_ids = (d_idx * np.int64(n_nodes) + rows).astype(np.int64)
    return DiaStructure(
        offsets=uniq,
        slot_ids=slot_ids,
        n_nodes=int(n_nodes),
        n_diags=int(uniq.size),
    )


@dataclass
class HybridStructure:
    """DIA bands for the dominant offsets + a small COO remainder.

    Meshes with near-lattice numbering (the built-in mesher's row-sorted
    output) concentrate >90% of couplings in a few dozen (col-row) offsets;
    the tail goes into a scatter-add remainder so the hot SpMV is almost
    all band rolls.

    offsets: [D] chosen band offsets (0 always included).
    slot_ids: [E*9] destinations: band slots in [0, D*N), remainder blocks
              at D*N + r.
    rem_rows/rem_cols: [R] node indices of the remainder blocks.
    """

    offsets: np.ndarray
    slot_ids: np.ndarray
    rem_rows: np.ndarray
    rem_cols: np.ndarray
    n_nodes: int
    n_diags: int

    @property
    def n_rem(self) -> int:
        return int(self.rem_rows.size)


def build_hybrid_structure(
    tris: np.ndarray, n_nodes: int, max_diags: int = 48
) -> HybridStructure:
    """Band + remainder pattern: top offsets by coupling count, chosen in
    SIGN-SYMMETRIC +/- pairs (every offset appears with its mirror and the
    mirror's count is identical -- ordered pair enumeration). Symmetry is
    what lets the upload/persist layer ship only the d >= 0 half of the
    assembled bands (fem/solve._upload_flat_device) and reconstruct the
    rest on device; a count-only top-K can split a pair at the cutoff."""
    tris = np.asarray(tris, dtype=np.int64)
    rows = np.repeat(tris, 3, axis=1).reshape(-1)
    cols = np.tile(tris, (1, 3)).reshape(-1)
    offs = cols - rows
    uniq, inverse, counts = np.unique(offs, return_inverse=True, return_counts=True)

    nonneg = np.where(uniq >= 0)[0]
    ranked = nonneg[np.argsort(-counts[nonneg], kind="stable")]
    budget = int(max_diags)
    chosen_list = []
    for idx in ranked:
        off = int(uniq[idx])
        cost = 1 if off == 0 else 2
        if budget < cost:
            continue
        chosen_list.append(off)
        if off != 0:
            chosen_list.append(-off)
        budget -= cost
    if 0 not in chosen_list:  # diagonal blocks always exist; keep offset 0
        chosen_list = [0] + chosen_list[: max_diags - 1]
    chosen_offsets = np.sort(np.array(chosen_list, dtype=uniq.dtype))

    in_band = np.isin(uniq, chosen_offsets)[inverse]
    d_idx = np.searchsorted(chosen_offsets, offs)
    band_slots = d_idx * n_nodes + rows

    # remainder: unique (row, col) blocks among out-of-band pairs
    rem_keys = rows[~in_band] * np.int64(n_nodes) + cols[~in_band]
    rem_uniq, rem_inv = np.unique(rem_keys, return_inverse=True)
    d = chosen_offsets.size
    slot_ids = np.where(in_band, band_slots, 0)
    slot_ids[~in_band] = d * n_nodes + rem_inv

    return HybridStructure(
        offsets=chosen_offsets,
        slot_ids=slot_ids.astype(np.int64),
        rem_rows=(rem_uniq // n_nodes).astype(np.int32),
        rem_cols=(rem_uniq % n_nodes).astype(np.int32),
        n_nodes=int(n_nodes),
        n_diags=int(d),
    )


def assemble_hybrid(
    ke: jax.Array, slot_ids, n_nodes: int, n_diags: int, n_rem: int
):
    """Device assembly -> (bands [D,2,2,N], rem [R,2,2])."""
    from .assembly import element_blocks

    blocks = element_blocks(ke)
    flat = jax.ops.segment_sum(
        blocks, jnp.asarray(slot_ids), num_segments=n_diags * n_nodes + n_rem
    )
    bands = flat[: n_diags * n_nodes].reshape(n_diags, n_nodes, 2, 2)
    return bands.transpose(0, 2, 3, 1), flat[n_diags * n_nodes :]


def hybrid_matvec(
    bands: jax.Array,
    offsets: tuple[int, ...],
    rem_vals: jax.Array,  # [R, 2, 2]
    rem_rows: jax.Array,  # [R]
    rem_cols: jax.Array,  # [R]
    u: jax.Array,  # [2, N]
):
    """y = K u: band rolls + a small COO scatter-add remainder."""
    y = dia_matvec(bands, offsets, u)
    ug = u[:, rem_cols]  # [2, R]
    contrib = jnp.einsum("rij,jr->ir", rem_vals, ug, precision="highest")  # [2, R]
    return y.at[:, rem_rows].add(contrib)


def assemble_dia(ke: jax.Array, slot_ids, n_nodes: int, n_diags: int) -> jax.Array:
    """Device assembly: element blocks -> bands [D, 2, 2, N] (N minormost)."""
    from .assembly import element_blocks

    blocks = element_blocks(ke)  # [E*9, 2, 2]
    flat = jax.ops.segment_sum(
        blocks, jnp.asarray(slot_ids), num_segments=n_diags * n_nodes
    )  # [D*N, 2, 2]
    return flat.reshape(n_diags, n_nodes, 2, 2).transpose(0, 2, 3, 1)


def _pair_major_slots(slot_ids: jax.Array, n_elements: int) -> jax.Array:
    """Reorder [E*9] a-major slot ids to the [3,3,E] pair-major layout of
    element.pair_block_fields."""
    return (
        jnp.asarray(slot_ids).reshape(n_elements, 3, 3)
        .transpose(1, 2, 0)
        .reshape(-1)
    )


def _scatter_fields(fields, slot_ids, num_segments):
    """Scatter the four scalar pair fields -> [2, 2, num_segments]."""
    k00, k01, k10, k11 = fields

    def scat(k):
        return jax.ops.segment_sum(
            k.reshape(-1), slot_ids, num_segments=num_segments
        )

    return jnp.stack(
        [
            jnp.stack([scat(k00), scat(k01)]),
            jnp.stack([scat(k10), scat(k11)]),
        ]
    )


def assemble_dia_fused(
    coords, tris, e_mod, nu, t, slot_ids, n_nodes: int, n_diags: int
) -> jax.Array:
    """Stiffness + band scatter without the [E,6,6] tensor -> [D,2,2,N].

    Four scalar segment_sums over [3,3,E] closed-form block fields (see
    element.pair_block_fields) instead of one [E*9,2,2] block scatter, so
    no [E,6,6] stiffness tensor is ever materialised."""
    from .element import pair_block_fields

    fields = pair_block_fields(coords, tris, e_mod, nu, t)
    slots = _pair_major_slots(slot_ids, tris.shape[0])
    flat = _scatter_fields(fields, slots, n_diags * n_nodes)  # [2,2,D*N]
    return flat.reshape(2, 2, n_diags, n_nodes).transpose(2, 0, 1, 3)


def assemble_hybrid_fused(
    coords, tris, e_mod, nu, t, slot_ids, n_nodes: int, n_diags: int, n_rem: int
):
    """Fused scalar-field version of `assemble_hybrid`:
    -> (bands [D,2,2,N], rem [R,2,2])."""
    from .element import pair_block_fields

    fields = pair_block_fields(coords, tris, e_mod, nu, t)
    slots = _pair_major_slots(slot_ids, tris.shape[0])
    flat = _scatter_fields(fields, slots, n_diags * n_nodes + n_rem)
    bands = flat[:, :, : n_diags * n_nodes].reshape(2, 2, n_diags, n_nodes)
    rem = flat[:, :, n_diags * n_nodes :]  # [2, 2, R]
    return bands.transpose(2, 0, 1, 3), rem.transpose(2, 0, 1)


def dia_matvec_blocks(
    bands: jax.Array, offsets: tuple[int, ...], u: jax.Array
):
    """y = K u for m x m blocks: bands [D, m, m, N], u/y [m, N].

    `offsets` must be static Python ints (one fused roll+FMA per band).
    Rolls wrap, but every band is zero wherever its shifted index would be
    invalid, so wraparound contributes exactly 0 -- and genuine periodic
    connectivity (annulus ring wrap) is just another offset. Used for the
    2x2 node-DOF operator (m=2) and the 3-near-nullspace-mode coarse AMG
    operators (m=3).
    """
    m = u.shape[0]
    ys = [jnp.zeros_like(u[0]) for _ in range(m)]
    for d_idx, off in enumerate(offsets):
        shifted = jnp.roll(u, -off, axis=1) if off != 0 else u
        b = bands[d_idx]
        # explicit block FMAs: exact in the field dtype, and fused with
        # the rolls (an einsum would be a separate contraction)
        for i in range(m):
            acc = ys[i]
            for j in range(m):
                acc = acc + b[i, j] * shifted[j]
            ys[i] = acc
    return jnp.stack(ys)


def dia_matvec(bands: jax.Array, offsets: tuple[int, ...], u: jax.Array):
    """y = K u with u, y in [2, N] layout (see dia_matvec_blocks)."""
    return dia_matvec_blocks(bands, offsets, u)


def dia_diag_blocks(bands: jax.Array, offsets: tuple[int, ...]) -> jax.Array:
    """The 2x2 diagonal blocks, [2, 2, N] (offset-0 band)."""
    zero_idx = offsets.index(0)
    return bands[zero_idx]


def make_dia_operator(bands: jax.Array, offsets: tuple[int, ...]):
    """op(u [2, N]) -> K u, closing over the bands."""

    def op(u: jax.Array) -> jax.Array:
        return dia_matvec(bands, offsets, u)

    return op


def make_hybrid_operator(
    bands: jax.Array,
    offsets: tuple[int, ...],
    rem_vals: jax.Array,
    rem_rows: jax.Array,
    rem_cols: jax.Array,
):
    """op(u [2, N]) -> K u for the band + COO-remainder format (see
    hybrid_matvec)."""

    def op(u: jax.Array) -> jax.Array:
        return hybrid_matvec(bands, offsets, rem_vals, rem_rows, rem_cols, u)

    return op


def block_jacobi_inverse_t(diag_blocks: jax.Array, free_mask: jax.Array):
    """Closed-form inverse of the reduced diagonal, transposed layout.

    diag_blocks [2,2,N], free_mask [2,N] -> returns apply(r [2,N]) -> [2,N].
    """
    f = free_mask
    outer = f[:, None, :] * f[None, :, :]  # [2,2,N]
    d = diag_blocks * outer
    d = d.at[0, 0].add(1.0 - f[0])
    d = d.at[1, 1].add(1.0 - f[1])
    a, b = d[0, 0], d[0, 1]
    c, e = d[1, 0], d[1, 1]
    det = a * e - b * c
    det = jnp.where(det == 0, 1.0, det)
    inv00, inv01 = e / det, -b / det
    inv10, inv11 = -c / det, a / det

    def apply(r: jax.Array) -> jax.Array:
        return jnp.stack(
            [inv00 * r[0] + inv01 * r[1], inv10 * r[0] + inv11 * r[1]]
        )

    return apply
