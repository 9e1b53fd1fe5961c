"""Node renumbering: band recovery on shuffled meshes + solve parity.

The reference accepts arbitrary .msh node orderings (src/mesher.rs:536-704);
its dense solver is order-insensitive. Here the ordering decides the SpMV
format, so `renumber` must (a) recover a banded ordering from a shuffled
mesh and (b) leave solve results bit-identical in the caller's order.
"""

import numpy as np
import pytest

from magnetite_tpu.bc import apply_boundary_conditions
from magnetite_tpu.config import SolverOptions
from magnetite_tpu.fem.dia import build_dia_structure
from magnetite_tpu.fem.solve import compile_problem, solve_system
from magnetite_tpu.meshing.core import Mesh
from magnetite_tpu.meshing.delaunay_backend import triangulate
from magnetite_tpu.meshing.generators import rect_mesh
from magnetite_tpu.meshing.reorder import (
    apply_permutation,
    band_stats,
    geometric_order,
    rcm_order,
    renumber,
)
from tests.conftest import make_rule


def _delaunay_plate(h=0.12):
    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    return triangulate([outer, hole], 0.0, h)


def _shuffle(mesh, seed=7):
    rng = np.random.default_rng(seed)
    perm = rng.permutation(mesh.num_nodes)
    return apply_permutation(mesh, perm), perm


def _tension_rules():
    from magnetite_tpu.config import BoundaryRegion

    return (
        make_rule("left", BoundaryRegion(x_max=1e-6), ux=0.0, uy=0.0),
        make_rule("right", BoundaryRegion(x_min=3.0 - 1e-6), ux=0.01, fy=0.0),
    )


def test_shuffle_destroys_bands_geometric_recovers():
    mesh = _delaunay_plate()
    n = mesh.num_nodes
    assert build_dia_structure(mesh.tris, n, max_diags=48) is not None
    shuffled, _ = _shuffle(mesh)
    assert build_dia_structure(shuffled.tris, n, max_diags=48) is None

    fixed, perm, stats = renumber(shuffled, method="geometric")
    assert sorted(perm.tolist()) == list(range(n))
    assert build_dia_structure(fixed.tris, n, max_diags=48) is not None
    assert stats.n_offsets <= 48


def test_rcm_is_valid_permutation_and_reduces_bandwidth():
    mesh = rect_mesh(20, 14)
    plain = Mesh(coords=mesh.coords, tris=mesh.tris)  # strip grid metadata
    shuffled, _ = _shuffle(plain, seed=3)
    before = band_stats(shuffled.tris)
    order = rcm_order(shuffled.tris, shuffled.num_nodes)
    assert sorted(order.tolist()) == list(range(shuffled.num_nodes))
    after = band_stats(apply_permutation(shuffled, order).tris)
    assert after.bandwidth < before.bandwidth / 4


def test_geometric_order_matches_builtin_mesher_ordering():
    # the delaunay backend already emits a lattice-row ordering; re-deriving
    # it geometrically must not make the offset set worse
    mesh = _delaunay_plate()
    native = band_stats(mesh.tris)
    reordered = apply_permutation(
        mesh, geometric_order(mesh.coords, mesh.tris)
    )
    redone = band_stats(reordered.tris)
    assert redone.n_offsets <= max(native.n_offsets, 48)


def test_solve_parity_original_vs_shuffled(metadata):
    mesh = _delaunay_plate(h=0.18)
    rules = _tension_rules()
    res = solve_system(
        mesh, apply_boundary_conditions(mesh.coords, rules), metadata
    )

    shuffled, perm_s = _shuffle(mesh)
    bca_s = apply_boundary_conditions(shuffled.coords, rules)
    problem = compile_problem(shuffled, bca_s, metadata)
    # auto renumbering must rescue the shuffled mesh from gather-ELL
    assert problem.mode in ("dia", "hybrid")
    assert problem.perm is not None
    res_s = problem.solve()

    # res_s is reported in the SHUFFLED order: node i == original perm_s[i]
    np.testing.assert_allclose(res_s.u, res.u[perm_s], rtol=0, atol=1e-9)
    np.testing.assert_allclose(res_s.f, res.f[perm_s], rtol=1e-6, atol=1e-4)


def test_renumber_off_falls_back_to_ell(metadata):
    mesh, _ = _shuffle(_delaunay_plate(h=0.2))
    bca = apply_boundary_conditions(mesh.coords, _tension_rules())
    problem = compile_problem(
        mesh, bca, metadata, SolverOptions(renumber="off", operator="ell")
    )
    assert problem.mode == "ell"
    assert problem.perm is None
    assert problem.solve().converged


def _gmsh_style_msh_text(mesh):
    """Serialize a mesh as MSH 4.1 ASCII with gmsh's entity ordering:
    boundary nodes in one block first, interior nodes after -- the
    band-hostile numbering real gmsh output arrives with."""
    n = mesh.num_nodes
    # boundary nodes = nodes on edges that belong to exactly one triangle
    edges = {}
    for tri in mesh.tris:
        for a, b in ((0, 1), (1, 2), (2, 0)):
            key = tuple(sorted((int(tri[a]), int(tri[b]))))
            edges[key] = edges.get(key, 0) + 1
    boundary = sorted({v for k, c in edges.items() if c == 1 for v in k})
    bset = set(boundary)
    interior = [i for i in range(n) if i not in bset]
    order = boundary + interior  # new file order: old index order[i]
    tag_of = {old: i + 1 for i, old in enumerate(order)}

    lines = ["$MeshFormat", "4.1 0 8", "$EndMeshFormat"]
    lines += ["$Entities", "0 0 1 0", "1 0 0 0 1 1 0 0 0", "$EndEntities"]
    lines += ["$Nodes", f"2 {n} 1 {n}"]
    lines += [f"1 1 0 {len(boundary)}"]
    lines += [str(tag_of[v]) for v in boundary]
    lines += [f"{mesh.coords[v, 0]} {mesh.coords[v, 1]} 0" for v in boundary]
    lines += [f"2 1 0 {len(interior)}"]
    lines += [str(tag_of[v]) for v in interior]
    lines += [f"{mesh.coords[v, 0]} {mesh.coords[v, 1]} 0" for v in interior]
    lines += ["$EndNodes", "$Elements", f"1 {mesh.num_elements} 1 {mesh.num_elements}"]
    lines += [f"2 1 2 {mesh.num_elements}"]
    for e, tri in enumerate(mesh.tris):
        lines.append(
            f"{e + 1} {tag_of[int(tri[0])]} {tag_of[int(tri[1])]} {tag_of[int(tri[2])]}"
        )
    lines += ["$EndElements", ""]
    return "\n".join(lines)


def test_gmsh_ordered_msh_gets_renumbered_banded_solve(metadata):
    """End-to-end: an MSH file with gmsh's boundary-first numbering lands on
    the banded operator via auto renumbering, and the solve matches the
    natively-ordered mesh."""
    from magnetite_tpu.meshing.msh import parse_msh

    native = _delaunay_plate(h=0.15)
    parsed = parse_msh(_gmsh_style_msh_text(native))
    assert parsed.num_nodes == native.num_nodes

    # boundary-first numbering is band-hostile at this size
    assert build_dia_structure(parsed.tris, parsed.num_nodes, max_diags=48) is None

    rules = _tension_rules()
    problem = compile_problem(
        parsed, apply_boundary_conditions(parsed.coords, rules), metadata
    )
    assert problem.mode in ("dia", "hybrid")
    assert problem.perm is not None
    res = problem.solve()

    ref = solve_system(
        native, apply_boundary_conditions(native.coords, rules), metadata
    )
    # match nodes by coordinates (orderings differ)
    from scipy.spatial import cKDTree

    idx = cKDTree(native.coords).query(parsed.coords)[1]
    np.testing.assert_allclose(
        res.u, ref.u[idx], atol=1e-9 * max(np.abs(ref.u).max(), 1e-30)
    )


@pytest.fixture
def logging_on():
    """Turn logging on for one test and restore the state it found (the
    flag is process-global, and a worker runs many test files)."""
    from magnetite_tpu.utils import logging as mlog

    prev = mlog._enabled
    mlog.set_logging(True)
    yield
    mlog.set_logging(prev)


def test_large_band_hostile_mesh_recovers_or_warns(capsys, logging_on):
    """A >200k-node mesh where geometric row-binning
    fails must NOT silently land on gather-ELL. The renumberer now runs
    RCM at any size when geometric stays band-hostile, and warns when the
    best ordering still is. Either outcome -- banded recovery or the
    warning -- is a pass; silence with a hostile ordering is the bug."""
    mesh = rect_mesh(549, 549)  # 302,500 nodes
    coords = mesh.coords.copy()
    ymax = coords[:, 1].max()
    # cubic grading: most row spacings shrink below the geometric binning
    # pitch, collapsing many mesh rows per bin -> hostile offset spread
    coords[:, 1] = (coords[:, 1] / ymax) ** 3 * ymax
    rng = np.random.default_rng(11)
    shuffle = rng.permutation(mesh.num_nodes)
    inv = np.empty_like(shuffle)
    inv[shuffle] = np.arange(mesh.num_nodes)
    hostile = Mesh(coords=coords[inv], tris=shuffle[mesh.tris])

    _, perm, stats = renumber(hostile, method="auto", top_k=48)
    err = capsys.readouterr().err
    assert stats.remainder_frac == 0.0 or "band-hostile" in err, (
        stats,
        err,
    )
