"""chip_smoke.py's phases at tiny sizes on the CPU, its four-device phase on
four virtual CPU devices, and its refusal to report without a GPU.

Each phase raises on a missed tolerance, so a phase that returns passed its
own checks; the tests add what a tiny size can show about the records."""

import json
import os
import shutil
import subprocess
import sys

import jax
import numpy as np
import pytest

import bench
import chip_smoke

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _records(capsys):
    return [
        json.loads(line)
        for line in capsys.readouterr().out.splitlines()
        if line.startswith("{")
    ]


def test_cli_phase(capsys):
    rec = chip_smoke.phase_cli(chip_smoke.TINY)
    assert rec["u_err"] <= rec["u_tol"]
    assert rec["stress_sign_mismatch"] == 0
    # x64 is on in the tests, so the CLI's own rule picks f64 on the CPU
    assert rec["dtype"] == "float64" and rec["u_tol"] == chip_smoke.U_TOL_F64
    assert _records(capsys)[-1]["phase"] == "1-cli"


def test_plate_phase(capsys):
    chip_smoke.phase_plate(chip_smoke.TINY)
    recs = _records(capsys)
    phases = [r["phase"] for r in recs]
    assert phases == ["2-plate", "2-plate", "2-plate-small"]
    assert recs[0]["operator"] == "stencil" and recs[0]["refined"]
    assert recs[1]["kernel"] == "stencil_matvec_f32"
    assert recs[2]["u_err"] <= chip_smoke.U_TOL_F64


def test_delaunay_phase(capsys):
    chip_smoke.phase_delaunay(chip_smoke.TINY)
    recs = _records(capsys)
    solve = [r for r in recs if r["phase"] == "3-delaunay" and "kernel" not in r]
    assert solve[0]["preconditioner"] == "amg" and solve[0]["refined"]
    kernels = {r["kernel"] for r in recs if "kernel" in r}
    assert kernels == {
        "dia_matvec_f32", "dia_matvec_f64", "amg_level0_transfer_pair_f32"
    }
    assert recs[-1]["phase"] == "3-delaunay-small"


def test_sweeps_phase(capsys):
    chip_smoke.phase_sweeps(chip_smoke.TINY)
    recs = _records(capsys)
    assert [r["phase"] for r in recs] == [
        "4-sweep", "4-unstructured-sweep", "4-unstructured-sweep"
    ]
    for r in recs[:2]:
        assert r["lanes"] == chip_smoke.TINY["lanes"]
        assert r["lane_u_err"] <= r["u_tol"]
    assert recs[2]["kernel"] == "lane_dia_matvec_f32"


def test_four_cards_phase_on_virtual_devices(capsys):
    assert len(jax.devices()) >= 4
    chip_smoke.phase_four_cards(jax.devices(), chip_smoke.TINY)
    recs = _records(capsys)
    assert [r["phase"] for r in recs] == [
        "four-delaunay-1d", "four-plate-1d", "four-plate-2x2",
        "four-sweep-lanes",
    ]
    assert [r.get("layout") for r in recs[:3]] == ["4", "4", "2x2"]
    for r in recs[:3]:
        assert r["u_err_vs_single"] <= chip_smoke.U_TOL_F64


def test_main_refuses_a_cpu(capsys):
    assert chip_smoke.main([]) == 2
    out = capsys.readouterr()
    assert '"ok"' not in out.out and "no GPU" in out.err


def test_script_alone_or_on_cpu_prints_no_result(tmp_path):
    """Run as the driver does: no GPU here, and a directory holding only
    the script, must both end nonzero without an ok line."""
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    for cwd, script in ((REPO, "chip_smoke.py"), (tmp_path, "chip_smoke.py")):
        out = subprocess.run(
            [sys.executable, script], cwd=cwd, env=env,
            capture_output=True, text=True, timeout=120,
        )
        assert out.returncode != 0
        assert '"ok"' not in out.stdout


def test_peak_share_table():
    assert bench.peak_share(1675.0, "NVIDIA H100 80GB HBM3") == 0.5
    assert bench.peak_share(1675.0, "some other card") is None


def test_slope_seconds_cancels_fixed_costs():
    """A chain of elementwise steps: positive, finite seconds per step."""
    x0 = jax.numpy.ones(1 << 16, jax.numpy.float32)
    sec = bench.slope_seconds(lambda v: v * 0.5 + 0.25, x0, (), 10, 60)
    assert np.isfinite(sec)


def test_check_raises_on_a_missed_tolerance():
    chip_smoke.check(True, "fine")
    with pytest.raises(chip_smoke.SmokeFailure, match="u error"):
        chip_smoke.check(False, "u error 1e-3")
