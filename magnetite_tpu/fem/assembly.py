"""Global stiffness assembly: segment_sum into a padded block-ELL layout.

The reference assembles a DENSE (2N)^2 matrix by scalar scatter-adds
(src/solver.rs:290-331) and then rescans it to CSR (src/solver.rs:124-137) --
O(N^2) memory, the one thing this rebuild must not replicate.

Design:
  * Sparsity STRUCTURE (which node couples to which) depends only on mesh
    connectivity -- built once on host with numpy (`build_ell_structure`),
    cached per mesh. Node-block granularity: each coupled node pair is one
    2x2 block; Delaunay meshes have ~7 neighbors/node, so a padded
    [N, K, 2, 2] ELL layout wastes little.
  * Numeric VALUES are assembled on device in one `segment_sum` over the
    E*9 per-element 2x2 blocks (`assemble_ell`) -- no data-dependent shapes,
    fully jittable, O(nnz) memory.
"""

from __future__ import annotations

from dataclasses import dataclass

import jax
import jax.numpy as jnp
import numpy as np


@dataclass
class EllStructure:
    """Static sparsity pattern of the global stiffness matrix.

    cols:     [N, K] int32. Column (node) index of each stored 2x2 block.
              Padding slots point at the row's own node (their block stays 0).
    slot_ids: [E*9] int32. For element e and local node pair (a, b), the flat
              destination n*K + k of its 2x2 contribution block.
    n_nodes, width: dimensions (width == K).
    """

    cols: np.ndarray
    slot_ids: np.ndarray
    n_nodes: int
    width: int

    @property
    def nnz_blocks(self) -> int:
        return self.n_nodes * self.width


def build_ell_structure(tris: np.ndarray, n_nodes: int) -> EllStructure:
    """Build the block-ELL pattern from triangle connectivity (host).

    For every element, all 9 ordered node pairs (a,b) couple. We enumerate
    the unique pairs per row, rank them by column index, and record for each
    of the E*9 contributions its destination slot. The native C++ builder
    (magnetite_tpu.native) is used when available; numpy otherwise.
    """
    from ..native import ell_structure as native_ell

    native = native_ell(np.asarray(tris), int(n_nodes))
    if native is not None:
        cols, slot_ids, width = native
        return EllStructure(
            cols=cols, slot_ids=slot_ids, n_nodes=int(n_nodes), width=width
        )
    tris = np.asarray(tris, dtype=np.int64)
    e = tris.shape[0]
    # rows/cols of all E*9 ordered pairs, laid out [E, 3, 3] = (a, b)
    rows = np.repeat(tris, 3, axis=1).reshape(e, 3, 3)  # a varies on axis 1
    cols = np.tile(tris, (1, 3)).reshape(e, 3, 3)  # b varies on axis 2
    rows_f = rows.reshape(-1)
    cols_f = cols.reshape(-1)

    keys = rows_f * np.int64(n_nodes) + cols_f
    uniq, inverse = np.unique(keys, return_inverse=True)
    uniq_rows = uniq // n_nodes
    uniq_cols = uniq % n_nodes

    # per-row rank of each unique pair (uniq is sorted, so pairs of the same
    # row are contiguous and sorted by column)
    row_starts = np.searchsorted(uniq_rows, np.arange(n_nodes))
    counts = np.bincount(uniq_rows, minlength=n_nodes)
    width = int(counts.max()) if counts.size else 0
    ranks = np.arange(uniq.size) - row_starts[uniq_rows]

    ell_cols = np.tile(np.arange(n_nodes, dtype=np.int64)[:, None], (1, width))
    ell_cols[uniq_rows, ranks] = uniq_cols

    slot_ids = uniq_rows[inverse] * width + ranks[inverse]
    return EllStructure(
        cols=ell_cols.astype(np.int32),
        slot_ids=slot_ids.astype(np.int32),
        n_nodes=int(n_nodes),
        width=width,
    )


def element_blocks(ke: jax.Array) -> jax.Array:
    """Reshape ke [E,6,6] into per-node-pair 2x2 blocks [E*9, 2, 2].

    DOF layout within ke is [n0x, n0y, n1x, n1y, n2x, n2y]; block (a,b)
    is ke[2a:2a+2, 2b:2b+2], ordered to match `build_ell_structure`'s
    [E, 3, 3] pair enumeration.
    """
    e = ke.shape[0]
    blocks = ke.reshape(e, 3, 2, 3, 2).transpose(0, 1, 3, 2, 4)  # [E,3,3,2,2]
    return blocks.reshape(e * 9, 2, 2)


def assemble_ell(ke: jax.Array, structure: EllStructure) -> jax.Array:
    """Device-side assembly: scatter-add all element blocks into the ELL data.

    Returns ell_data [N, K, 2, 2].
    """
    blocks = element_blocks(ke)
    slot_ids = jnp.asarray(structure.slot_ids)
    flat = jax.ops.segment_sum(
        blocks, slot_ids, num_segments=structure.nnz_blocks
    )
    return flat.reshape(structure.n_nodes, structure.width, 2, 2)


def extract_block_diagonal(
    ell_data: jax.Array, cols: jax.Array
) -> jax.Array:
    """Pull the diagonal 2x2 block of each row: [N, 2, 2].

    The diagonal block sits wherever cols[n, k] == n (exactly one real slot;
    padding slots also point at n but hold zeros, so summing is exact).
    """
    n = ell_data.shape[0]
    own = jnp.arange(n, dtype=cols.dtype)[:, None] == cols  # [N, K]
    return jnp.einsum("nk,nkij->nij", own.astype(ell_data.dtype), ell_data, precision="highest")


def assemble_dense(ke: jax.Array, tris: jax.Array, n_nodes: int) -> jax.Array:
    """Dense (2N)x(2N) assembly for small systems / testing."""
    e = ke.shape[0]
    dof = tris[:, :, None] * 2 + jnp.arange(2)[None, None, :]  # [E,3,2]
    dof = dof.reshape(e, 6)
    rows = jnp.repeat(dof, 6, axis=1).reshape(-1)
    cols = jnp.tile(dof, (1, 6)).reshape(-1)
    k = jnp.zeros((2 * n_nodes, 2 * n_nodes), dtype=ke.dtype)
    return k.at[rows, cols].add(ke.reshape(-1))


def ell_to_dense(ell_data: jax.Array, cols: jax.Array) -> jax.Array:
    """Expand block-ELL to a dense (2N)x(2N) matrix (testing only)."""
    n, k = cols.shape
    dense = jnp.zeros((n, 2, n, 2), dtype=ell_data.dtype)
    rows = jnp.repeat(jnp.arange(n), k)
    dense = dense.at[rows, :, cols.reshape(-1), :].add(
        ell_data.reshape(n * k, 2, 2)
    )
    return dense.reshape(2 * n, 2 * n)
