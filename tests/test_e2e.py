"""End-to-end pipeline tests on the bundled reference examples.

The Rust reference binary cannot run here (no cargo, no gmsh), so e2e
correctness is anchored two ways:
  * the full JSON->mesh->solve pipeline must agree with the independent
    dense NumPy oracle on the same mesh to ~1e-8 relative
  * physical sanity on each example (displacement magnitudes, BC pinning)
"""

import os
import subprocess
import sys

import numpy as np
import pytest

from magnetite_tpu import oracle
from magnetite_tpu.config import SolverOptions, load_simulation_input
from magnetite_tpu.fem.solve import solve_system
from magnetite_tpu.meshing import runner

EXAMPLES = "/root/reference/examples"


def _run_pipeline(input_json, geometry, max_cl_override=None):
    sim = load_simulation_input(input_json)
    if max_cl_override is not None:
        from dataclasses import replace

        sim = type(sim)(
            metadata=replace(
                sim.metadata, characteristic_length_max=max_cl_override
            ),
            boundary_rules=sim.boundary_rules,
        )
    mesh, bca = runner.run(
        geometry, sim, backend="delaunay", log=lambda m: None
    )
    result = solve_system(mesh, bca, sim.metadata)
    return sim, mesh, bca, result


def test_tensile_example_end_to_end_vs_oracle():
    sim, mesh, bca, result = _run_pipeline(
        f"{EXAMPLES}/tensile-example/input.json",
        [f"{EXAMPLES}/tensile-example/vertices.csv"],
        max_cl_override=0.9,  # keep oracle's dense solve tractable
    )
    assert mesh.num_elements > 100
    u_ref, f_ref, sigma_ref = oracle.solve(
        mesh.coords, mesh.tris, bca, sim.metadata
    )
    scale = np.abs(u_ref).max()
    np.testing.assert_allclose(result.u, u_ref, rtol=1e-7, atol=1e-8 * scale)
    s_scale = np.abs(sigma_ref).max()
    np.testing.assert_allclose(
        result.sigma, sigma_ref, rtol=1e-5, atol=1e-7 * s_scale
    )
    # physics: the right edge is pulled ux=3; left edge pinned
    right = mesh.coords[:, 0] > 10
    assert np.allclose(result.u[right, 0], 3.0)
    left = mesh.coords[:, 0] < -10
    assert np.allclose(result.u[left], 0.0)


def test_linkedin_example_end_to_end():
    sim, mesh, bca, result = _run_pipeline(
        f"{EXAMPLES}/linkedin-logo/input.json",
        [f"{EXAMPLES}/linkedin-logo/linkedin.svg"],
    )
    assert mesh.num_elements > 500
    # load rule prescribes uy=150 on the top band (y in (-30, 1))
    top = (mesh.coords[:, 1] > -30) & (mesh.coords[:, 1] < 1)
    assert top.any()
    assert np.allclose(result.u[top, 1], 150.0)
    # restraint pins the bottom band
    bottom = (mesh.coords[:, 1] > -700) & (mesh.coords[:, 1] < -590)
    assert np.allclose(result.u[bottom], 0.0)
    assert np.isfinite(result.stress).all()


def test_cover_example_end_to_end():
    sim, mesh, bca, result = _run_pipeline(
        f"{EXAMPLES}/cover-eample/input.json",
        [f"{EXAMPLES}/cover-eample/geom.svg"],
    )
    assert mesh.num_elements > 500
    assert np.isfinite(result.u).all()
    top = (mesh.coords[:, 1] > -8)
    assert np.allclose(result.u[top, 1], 10.0)


def test_cli_end_to_end(tmp_path):
    """Drive the real CLI surface: tensile example, CSV outputs."""
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    proc = subprocess.run(
        [
            sys.executable,
            "-m",
            "magnetite_tpu.cli",
            f"{EXAMPLES}/tensile-example/input.json",
            f"{EXAMPLES}/tensile-example/vertices.csv",
            "--skip",
            "--backend",
            "delaunay",
            "--out-dir",
            str(tmp_path),
        ],
        capture_output=True,
        text=True,
        env=env,
        cwd="/root/repo",
        timeout=500,
    )
    assert proc.returncode == 0, proc.stderr
    nodes = (tmp_path / "nodes.csv").read_text().splitlines()
    elements = (tmp_path / "elements.csv").read_text().splitlines()
    assert nodes[0] == "x,y,ux,uy"
    assert elements[0] == "n0,n1,n2,stress"
    assert len(nodes) > 100 and len(elements) > 100
    first = [float(v) for v in nodes[1].split(",")]
    assert len(first) == 4


def test_cli_error_exit_code(tmp_path):
    missing = str(tmp_path / "nope.json")
    proc = subprocess.run(
        [sys.executable, "-m", "magnetite_tpu.cli", missing, "geom.svg"],
        capture_output=True,
        text=True,
        cwd="/root/repo",
        timeout=120,
    )
    assert proc.returncode == 1
    assert "Received error: Input error" in proc.stderr
