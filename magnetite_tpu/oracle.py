"""Independent NumPy/SciPy oracles for parity testing.

A deliberately simple, separate implementation of the same plane-stress CST
formulation the reference implements in Rust (src/solver.rs), used as the
golden reference in tests: dense global matrix, boolean-index partitioning
(the reference's known/unknown row/col scheme, src/solver.rs:365-404), and a
direct `numpy.linalg.solve`. The JAX pipeline must agree with this to ~1e-10
on small meshes; agreement of two independent code paths stands in for the
Rust binary, which cannot run in this environment (no cargo toolchain).

Not a performance path -- O(N^2) memory by construction, like the reference.

The sparse variant (`sparse_stiffness`, `sparse_solve`,
`true_relative_residual`) is the same formulation vectorized over elements
into a scipy.sparse COO matrix, with `spsolve` on the free DOFs: it reaches
meshes of millions of elements, where it checks device solves by their
TRUE f64 residual.
"""

from __future__ import annotations

import numpy as np

from .bc import BCArrays
from .config import ModelMetadata


def d_matrix(e: float, nu: float) -> np.ndarray:
    return (e / (1.0 - nu * nu)) * np.array(
        [[1.0, nu, 0.0], [nu, 1.0, 0.0], [0.0, 0.0, (1.0 - nu) / 2.0]]
    )


def element_area(p: np.ndarray) -> float:
    """p [3,2] -> signed area."""
    return 0.5 * (
        p[0, 0] * (p[1, 1] - p[2, 1])
        + p[1, 0] * (p[2, 1] - p[0, 1])
        + p[2, 0] * (p[0, 1] - p[1, 1])
    )


def b_matrix(p: np.ndarray, area: float) -> np.ndarray:
    """p [3,2] -> B [3,6]."""
    beta = np.array([p[1, 1] - p[2, 1], p[2, 1] - p[0, 1], p[0, 1] - p[1, 1]])
    gamma = np.array([p[2, 0] - p[1, 0], p[0, 0] - p[2, 0], p[1, 0] - p[0, 0]])
    b = np.zeros((3, 6))
    b[0, 0::2] = beta
    b[1, 1::2] = gamma
    b[2, 0::2] = gamma
    b[2, 1::2] = beta
    return b / (2.0 * area)


def global_stiffness(
    coords: np.ndarray, tris: np.ndarray, e: float, nu: float, t: float
) -> np.ndarray:
    """Dense (2N)x(2N) global stiffness matrix."""
    n = coords.shape[0]
    k = np.zeros((2 * n, 2 * n))
    d = d_matrix(e, nu)
    for tri in tris:
        p = coords[tri]
        area = element_area(p)
        b = b_matrix(p, area)
        ke = b.T @ d @ b * area * t
        dof = np.empty(6, dtype=np.int64)
        dof[0::2] = 2 * np.asarray(tri)
        dof[1::2] = 2 * np.asarray(tri) + 1
        k[np.ix_(dof, dof)] += ke
    return k


def solve(
    coords: np.ndarray,
    tris: np.ndarray,
    bca: BCArrays,
    metadata: ModelMetadata,
):
    """Partition-and-solve exactly as the reference does.

    Returns (u [N,2], f [N,2], sigma [E,3]).
    """
    n = coords.shape[0]
    k = global_stiffness(
        coords,
        tris,
        metadata.youngs_modulus,
        metadata.poisson_ratio,
        metadata.part_thickness,
    )
    u_known = bca.u_known.reshape(-1)  # [2N]
    u_val = bca.u_value.reshape(-1)
    f_val = bca.f_value.reshape(-1)

    free = ~u_known
    # Reduced system: rows/cols of unknown displacements (== rows of known
    # forces, reference src/solver.rs:365-404).
    a = k[np.ix_(free, free)]
    rhs = f_val[free] - k[np.ix_(free, u_known)] @ u_val[u_known]
    u = u_val.copy()
    u[free] = np.linalg.solve(a, rhs)

    f = f_val.copy()
    f[u_known] = (k @ u)[u_known]

    d = d_matrix(metadata.youngs_modulus, metadata.poisson_ratio)
    sigma = np.zeros((tris.shape[0], 3))
    for i, tri in enumerate(tris):
        p = coords[tri]
        area = element_area(p)
        b = b_matrix(p, area)
        dof = np.empty(6, dtype=np.int64)
        dof[0::2] = 2 * np.asarray(tri)
        dof[1::2] = 2 * np.asarray(tri) + 1
        sigma[i] = d @ b @ u[dof]

    return u.reshape(-1, 2), f.reshape(-1, 2), sigma


def scalar_stress(sigma: np.ndarray, sign_threshold: float = 1.0) -> np.ndarray:
    """Reference scalar stress (src/solver.rs:524-533)."""
    mag = np.sqrt(sigma[:, 0] ** 2 + sigma[:, 1] ** 2)
    sign = np.where(sigma[:, 0] + sigma[:, 1] < sign_threshold, -1.0, 1.0)
    return sign * mag


# ------------------------------ sparse oracle --------------------------------


def _element_b_areas(coords: np.ndarray, tris: np.ndarray):
    """Vectorized `b_matrix`/`element_area`: -> (B [E,3,6], area [E])."""
    p = coords[tris]  # [E, 3, 2]
    x, y = p[..., 0], p[..., 1]
    area = 0.5 * (
        x[:, 0] * (y[:, 1] - y[:, 2])
        + x[:, 1] * (y[:, 2] - y[:, 0])
        + x[:, 2] * (y[:, 0] - y[:, 1])
    )
    beta = np.stack([y[:, 1] - y[:, 2], y[:, 2] - y[:, 0], y[:, 0] - y[:, 1]], 1)
    gamma = np.stack([x[:, 2] - x[:, 1], x[:, 0] - x[:, 2], x[:, 1] - x[:, 0]], 1)
    b = np.zeros((tris.shape[0], 3, 6))
    b[:, 0, 0::2] = beta
    b[:, 1, 1::2] = gamma
    b[:, 2, 0::2] = gamma
    b[:, 2, 1::2] = beta
    return b / (2.0 * area)[:, None, None], area


def _element_dofs(tris: np.ndarray) -> np.ndarray:
    t = np.asarray(tris, dtype=np.int64)
    dof = np.empty((t.shape[0], 6), dtype=np.int64)
    dof[:, 0::2] = 2 * t
    dof[:, 1::2] = 2 * t + 1
    return dof


def sparse_stiffness(
    coords: np.ndarray, tris: np.ndarray, e: float, nu: float, t: float
):
    """(2N)x(2N) global stiffness as scipy.sparse CSR (duplicates summed)."""
    import scipy.sparse as sp

    coords = np.asarray(coords, dtype=np.float64)
    b, area = _element_b_areas(coords, np.asarray(tris))
    ke = np.einsum("eri,rs,esj->eij", b, d_matrix(e, nu), b)
    ke *= (area * t)[:, None, None]
    dof = _element_dofs(tris)
    n = 2 * coords.shape[0]
    rows = np.repeat(dof, 6, axis=1).reshape(-1)
    cols = np.tile(dof, (1, 6)).reshape(-1)
    return sp.coo_matrix((ke.reshape(-1), (rows, cols)), shape=(n, n)).tocsr()


def _partition(bca: BCArrays):
    known = bca.u_known.reshape(-1)
    u_known_only = np.where(known, bca.u_value.reshape(-1), 0.0)
    return known, u_known_only, bca.f_value.reshape(-1)


def sparse_solve(
    coords: np.ndarray,
    tris: np.ndarray,
    bca: BCArrays,
    metadata: ModelMetadata,
    k=None,
):
    """`solve` with the sparse operator and a sparse direct factorization.

    Returns (u [N,2], f [N,2], sigma [E,3]); pass `k` to reuse an operator
    from `sparse_stiffness`."""
    from scipy.sparse.linalg import spsolve

    if k is None:
        k = sparse_stiffness(
            coords,
            tris,
            metadata.youngs_modulus,
            metadata.poisson_ratio,
            metadata.part_thickness,
        )
    known, u, f_val = _partition(bca)
    free = ~known
    rhs = f_val[free] - (k @ u)[free]
    u[free] = spsolve(k[free][:, free].tocsc(), rhs, permc_spec="MMD_AT_PLUS_A")
    f = f_val.copy()
    f[known] = (k @ u)[known]
    return (
        u.reshape(-1, 2),
        f.reshape(-1, 2),
        element_sigma(coords, tris, u.reshape(-1, 2), metadata),
    )


def element_sigma(
    coords: np.ndarray, tris: np.ndarray, u: np.ndarray, metadata: ModelMetadata
) -> np.ndarray:
    """sigma [E,3] = D B u_e for every element (vectorized)."""
    b, _ = _element_b_areas(np.asarray(coords, np.float64), np.asarray(tris))
    ue = np.asarray(u, np.float64).reshape(-1)[_element_dofs(tris)]  # [E, 6]
    d = d_matrix(metadata.youngs_modulus, metadata.poisson_ratio)
    return np.einsum("rs,esj,ej->er", d, b, ue)


def true_relative_residual(k, bca: BCArrays, u: np.ndarray) -> float:
    """||K_ff u_f - rhs|| / ||rhs|| in f64, rhs = f_f - K_fk u_k, for a
    candidate solution u [N,2] (its prescribed DOFs are taken from bca)."""
    known, u_k, f_val = _partition(bca)
    free = ~known
    u_full = np.where(known, u_k, np.asarray(u, np.float64).reshape(-1))
    rhs = f_val[free] - (k @ u_k)[free]
    res = (k @ u_full)[free] - f_val[free]
    return float(np.linalg.norm(res) / max(np.linalg.norm(rhs), 1e-300))
