"""Smoke run of the solve path on an NVIDIA GPU, through the user entry points.

    python chip_smoke.py               # phases 0-4 on one GPU
    python chip_smoke.py --four-cards  # only the sharded paths, on four GPUs

Everything runs in ONE process (a JAX process reserves most of a card's
memory, so a second one would fail). Each phase prints one JSON line with its
sizes, iterations, tolerance, error against the reference, cold and warm
seconds and the device's peak bytes in use:

  0  device and card: a GPU is required; the card's name and power limit
     (nvidia-smi), jax's version, the compile-cache directory, and the native
     host library, rebuilt here from magnetite_tpu/_native/src.
  1  the CLI one-shot case, `magnetite_tpu.cli.entry` in-process BEFORE x64
     is turned on (the CLI picks its dtype from that flag, so it runs as a
     fresh user process would): a ~100k-element Delaunay plate with a hole
     from CSV polygons and a generated input JSON; CSV headers; u, reaction
     forces and stress against a scipy f64 direct solve of the same mesh.
  2  structured plate, 1,048,576 elements, f32 + f64 refinement to 1e-8
     (stencil, multigrid): the TRUE f64 residual with the sparse oracle, and
     a ~50k-element twin against spsolve.
  3  Delaunay plate, ~1M elements (DIA bands, f32 AMG V-cycle, f64 CG): the
     same two checks.
  4  4,096-lane sweeps, structured (compile_sweep) and unstructured
     (compile_unstructured_sweep); 8 lanes against scipy direct solves.

Phases 2-4 also print one "kernel" line per operator that replaced a
hand-written kernel of the previous accelerator: seconds per application by
the scan-length slope (bench.slope_seconds), bytes per application counted
from the shapes, GB/s, and the share of the card's peak bandwidth
(bench.HBM_PEAK_GBPS; none for an unknown card).

The last stdout line is {"ok": true, "device": {...}}. Any phase that raises
or misses its tolerance ends the run with a nonzero exit before that line.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

REPO = os.path.dirname(os.path.abspath(__file__))

# Tolerances. The f64 bars follow the solver's own targets; the f32 bars are
# set by what f32 arithmetic can hold (see each).
TRUE_REL_RESIDUAL = 2e-8  # phases 2-3: cg_rtol=1e-8 plus margin for the
#   independently assembled f64 operator
U_TOL_F64 = 1e-6  # max|u - u_ref| / max|u_ref|, the golden-test bar
#   (tests/test_golden.py) for f64-accurate solves
U_TOL_F32 = 5e-3  # f32 solves (the CLI default on the GPU, sweep lanes):
#   CG stops at the f32 residual floor (50*eps_f32 ~ 6e-6 relative, or at a
#   fixed lane budget), and the error in u is that residual times what the
#   preconditioner leaves of the condition number. Measured with the CLI
#   forced to f32 on the CPU at 50k elements: 6e-4; sweep lanes: 6e-5.
STRESS_TOL_REFINED = 1e-5  # two refined solves (single-device and sharded,
#   both recovering stress in f64) agree in stress to their u agreement
#   times the extent / h amplification of the strain differences
STRESS_TOL_F32 = 1e-2  # reactions (K u on the clamped DOFs) and stress
#   difference u over element-sized distances, which amplifies its error:
#   2.7e-3 and 1.0e-3 in the same CPU measurement

FULL = dict(
    cli_h=0.00815,  # ~100k elements on the 3 x 1 plate with a hole
    plate=(512, 1024),  # 1,048,576 elements
    plate_small=(112, 224),  # 50,176 elements
    delaunay_h=0.00258,  # ~1M elements (bench.py's unstructured phase)
    delaunay_small_h=0.0115,  # ~50k elements
    sweep_rect=(64, 32),
    sweep_h=0.03,
    lanes=4096,
    check_lanes=8,
    four_delaunay_h=0.0115,
    four_plate=(128, 256),
    slope=(50, 250),
)
TINY = dict(
    cli_h=0.12,
    plate=(16, 32),
    plate_small=(8, 16),
    delaunay_h=0.04,  # enough nodes for a multi-level AMG hierarchy
    delaunay_small_h=0.12,
    sweep_rect=(32, 16),
    sweep_h=0.04,
    lanes=16,
    check_lanes=4,
    four_delaunay_h=0.15,
    four_plate=(8, 16),
    slope=(2, 6),
)

E_MOD, NU, THICK = 69e9, 0.33, 0.5


class SmokeFailure(RuntimeError):
    pass


def check(ok: bool, message: str) -> None:
    if not ok:
        raise SmokeFailure(message)


def emit(record: dict) -> None:
    print(json.dumps(record), flush=True)


def peak_bytes():
    import jax

    stats = jax.devices()[0].memory_stats() or {}
    return stats.get("peak_bytes_in_use")


def rel_err(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / max(np.abs(b).max(), 1e-300))


def von_mises(sigma: np.ndarray) -> np.ndarray:
    sx, sy, txy = sigma[:, 0], sigma[:, 1], sigma[:, 2]
    return np.sqrt(sx * sx - sx * sy + sy * sy + 3.0 * txy * txy)


# --------------------------------- models -----------------------------------

OUTER = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
SQUARE_HOLE = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])


def metadata(h: float):
    from magnetite_tpu.config import ModelMetadata

    return ModelMetadata(E_MOD, NU, THICK, 0.0, h)


def delaunay_plate(h: float):
    """bench.py's unstructured plate: 3 x 1 with a square hole, left edge
    clamped, right edge pulled 0.01 in x with fy = 0."""
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import BoundaryRegion, BoundaryRule, BoundaryTarget
    from magnetite_tpu.meshing.delaunay_backend import triangulate

    mesh = triangulate([OUTER, SQUARE_HOLE], 0.0, h)
    rules = (
        BoundaryRule(
            "left", BoundaryRegion(x_max=1e-6), BoundaryTarget(ux=0.0, uy=0.0)
        ),
        BoundaryRule(
            "right",
            BoundaryRegion(x_min=3.0 - 1e-6),
            BoundaryTarget(ux=0.01, fy=0.0),
        ),
    )
    return mesh, apply_boundary_conditions(mesh.coords, rules)


def structured_plate(nr: int, nt: int):
    from bench import _plate_problem

    return _plate_problem(nr, nt)


def sparse_k(mesh, md):
    from magnetite_tpu import oracle

    return oracle.sparse_stiffness(
        mesh.coords, mesh.tris, md.youngs_modulus, md.poisson_ratio,
        md.part_thickness,
    )


# ---------------------------- kernel readings -------------------------------


def kernel_reading(phase, name, replaces, step, x0, args, nbytes, sizes):
    """Time `step(x, *args) -> x` by the scan-length slope and print one
    "kernel" line: seconds and bytes per application, GB/s, peak share."""
    import jax

    from bench import peak_share, slope_seconds

    l1, l2 = sizes["slope"]
    sec = slope_seconds(step, x0, args, l1, l2)
    gbps = nbytes / sec / 1e9 if sec > 0 else None
    kind = jax.devices()[0].device_kind
    emit(
        {
            "phase": phase,
            "kernel": name,
            "replaces": replaces,
            "us_per_apply": sec * 1e6,
            "bytes_per_apply": int(nbytes),
            "gbps": gbps,
            "peak_share": peak_share(gbps, kind) if gbps else None,
            "device_kind": kind,
        }
    )


def read_stencil(phase, mesh, bca, sizes):
    import jax.numpy as jnp

    from magnetite_tpu.fem.solve import _grid, _reduce_stencil
    from magnetite_tpu.fem.stencil import (
        assemble_stencil_structured,
        stencil_matvec,
    )

    rows, cols = mesh.grid_shape
    wrap = mesh.wrap_cols
    f32 = jnp.float32
    raw = assemble_stencil_structured(
        jnp.asarray(mesh.coords, f32), f32(E_MOD), f32(NU), f32(THICK),
        rows, cols, wrap,
    )
    st = _reduce_stencil(
        raw, _grid(jnp.asarray(~bca.u_known, f32), rows, cols), wrap
    )
    scale = f32(1.0 / float(jnp.abs(st).sum(axis=(0, 2)).max()))
    u0 = jnp.asarray(
        np.random.default_rng(0).standard_normal((2, rows, cols)), f32
    )
    kernel_reading(
        phase, "stencil_matvec_f32", "Pallas stencil kernel",
        lambda v, s: stencil_matvec(s, v, wrap) * scale, u0, (st,),
        (36 + 2 + 2) * rows * cols * 4, sizes,
    )


def _band_offsets(problem, mesh):
    from magnetite_tpu.fem.dia import build_dia_structure, build_hybrid_structure
    from magnetite_tpu.meshing.reorder import apply_permutation

    if problem.perm is not None:
        mesh = apply_permutation(mesh, problem.perm)
    n = mesh.num_nodes
    if problem.mode == "dia":
        return tuple(int(o) for o in build_dia_structure(mesh.tris, n).offsets)
    return tuple(int(o) for o in build_hybrid_structure(mesh.tris, n).offsets)


def read_dia_and_transfers(phase, problem, mesh, sizes):
    """The f32 band matvec (V-cycle level 0), the f64 band matvec (the CG
    operator; replaces the double-float pair kernel), and the level-0 AMG
    transfer pair P0 / P0^T (replaces the windowed one-hot kernel)."""
    import jax.numpy as jnp

    from magnetite_tpu.fem.dia import dia_matvec

    bands64 = problem.args[-1][0]
    offsets = _band_offsets(problem, mesh)
    d, n = bands64.shape[0], bands64.shape[-1]
    check(d == len(offsets), f"band count {d} != {len(offsets)} offsets")
    rng = np.random.default_rng(1)
    for dtype, name, replaces in (
        (jnp.float32, "dia_matvec_f32", "Pallas DIA kernel"),
        (jnp.float64, "dia_matvec_f64", "double-float Pallas DIA kernel"),
    ):
        bands = bands64.astype(dtype)
        scale = dtype(1.0 / float(jnp.abs(bands).sum(axis=(0, 2)).max()))
        u0 = jnp.asarray(rng.standard_normal((2, n)), dtype)
        item = jnp.dtype(dtype).itemsize
        kernel_reading(
            phase, name, replaces,
            lambda v, b: dia_matvec(b, offsets, v) * scale, u0, (bands,),
            (4 * d + 4) * n * item, sizes,
        )

    setup = problem.amg_setup
    if setup is None or setup.fast0 is None or not setup.transfers:
        return
    agg, p0, ptc, ptv, _ = setup.fast0
    n0, n1 = p0.shape[0], setup.level_sizes[1][0]
    w = ptc.shape[1]
    f32 = jnp.float32
    hp = {"precision": "highest"}

    def pair(ec, agg_, p0_, ptc_, ptv_):
        uf = jnp.einsum("nij,nj->ni", p0_, ec[agg_], **hp).T  # [2, n0]
        return jnp.einsum("nwij,jnw->ni", ptv_, uf[:, ptc_], **hp)

    # prolong reads p0, agg and the gathered coarse rows, writes [2, n0];
    # restrict reads P0^T values, columns and the gathered fine rows, writes
    # [n1, 3]
    nbytes = (n0 * (6 + 1 + 3 + 2) + n1 * w * (6 + 1 + 2) + n1 * 3) * 4
    kernel_reading(
        phase, "amg_level0_transfer_pair_f32",
        "Pallas windowed one-hot transfer kernel",
        pair, jnp.asarray(rng.standard_normal((n1, 3)), f32),
        (jnp.asarray(agg, jnp.int32), jnp.asarray(p0, f32),
         jnp.asarray(ptc, jnp.int32), jnp.asarray(ptv, f32)),
        nbytes, sizes,
    )


def read_lane_dia(phase, compiled, lanes, sizes):
    import jax.numpy as jnp

    from magnetite_tpu.parallel.sweep import lane_dia_matvec

    bands = compiled.bands_sm
    offsets = compiled.offsets
    d, n = bands.shape[0], bands.shape[-1]
    scale = jnp.float32(1.0 / float(jnp.abs(bands).sum(axis=(0, 2)).max()))
    u0 = jnp.asarray(
        np.random.default_rng(2).standard_normal((2, n, lanes)), jnp.float32
    )
    kernel_reading(
        phase, "lane_dia_matvec_f32", "Pallas lane-DIA kernel",
        lambda v, b: lane_dia_matvec(b, offsets, v) * scale, u0, (bands,),
        (4 * d * n + 4 * n * lanes) * 4, sizes,
    )


# --------------------------------- phases -----------------------------------


def phase_device(four_cards: bool) -> dict:
    """Phase 0. Raises unless JAX's first device is a GPU."""
    import jax

    dev = jax.devices()[0]
    check(dev.platform == "gpu", f"no GPU: JAX's first device is {dev}")
    want = 4 if four_cards else 1
    check(
        len(jax.devices()) >= want,
        f"{want} GPU(s) needed, JAX sees {len(jax.devices())}",
    )
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip().splitlines()
    for line in smi:
        print(line, flush=True)
    from magnetite_tpu.utils.jaxcache import enable_persistent_cache

    cache = enable_persistent_cache()
    make = subprocess.run(
        ["make", "-B", "-C", os.path.join(REPO, "magnetite_tpu", "_native")],
        capture_output=True, text=True, timeout=600,
    )
    from magnetite_tpu import native

    record = {
        "phase": "0-device",
        "jax": jax.__version__,
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
        "card": smi,
        "compile_cache_dir": cache,
        "native_make_rc": make.returncode,
        "native_built": bool(native.available()),
    }
    emit(record)
    return record


def _write_cli_inputs(workdir: str, h: float):
    """Plate 3 x 1 with a 48-gon hole (r = 0.2) as CSV polygons + input."""
    t = np.linspace(0.0, 2.0 * np.pi, 48, endpoint=False)
    hole = np.stack([1.5 + 0.2 * np.cos(t), 0.5 + 0.2 * np.sin(t)], 1)
    paths = []
    for name, loop in (("outer.csv", OUTER), ("hole.csv", hole)):
        path = os.path.join(workdir, name)
        with open(path, "w") as f:
            f.write("x,y\n")
            f.writelines(f"{x!r},{y!r}\n" for x, y in loop.tolist())
        paths.append(path)
    spec = {
        "metadata": {
            "part_thickness": THICK,
            "material_elasticity": E_MOD,
            "poisson_ratio": NU,
            "characteristic_length_min": 0.0,
            "characteristic_length_max": h,
        },
        "boundary_conditions": {
            "clamp": {
                "region": {"x_target_max": 1e-6},
                "targets": {"ux": 0, "uy": 0, "fx": None, "fy": None},
            },
            "pull": {
                "region": {"x_target_min": 3.0 - 1e-6},
                "targets": {"ux": 0.01, "uy": None, "fx": None, "fy": 0},
            },
        },
    }
    input_path = os.path.join(workdir, "input.json")
    with open(input_path, "w") as f:
        json.dump(spec, f)
    return input_path, paths


def phase_cli(sizes) -> dict:
    """Phase 1: the CLI in-process, checked against a scipy f64 solve."""
    import contextlib
    import io
    import re

    import jax

    from magnetite_tpu import cli, oracle
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import load_simulation_input
    from magnetite_tpu.post.csv_out import read_elements_csv, read_nodes_csv

    with tempfile.TemporaryDirectory() as workdir:
        input_path, geometry = _write_cli_inputs(workdir, sizes["cli_h"])
        argv = [input_path, *geometry, "--skip", "--out-dir", workdir]
        times = []
        for _ in range(2):  # cold (compiles), then warm
            out = io.StringIO()
            t0 = time.perf_counter()
            with contextlib.redirect_stdout(out):
                cli.entry(argv)
            times.append(time.perf_counter() - t0)
        log = out.getvalue()
        iters = re.search(r"conjugate gradient in (\d+) iterations", log)
        check(iters is not None, "CLI did not report its CG iterations")
        with open(os.path.join(workdir, "nodes.csv")) as f:
            nodes_header = f.readline().strip()
        with open(os.path.join(workdir, "elements.csv")) as f:
            elements_header = f.readline().strip()
        nodes = read_nodes_csv(os.path.join(workdir, "nodes.csv"))
        tris, stress = read_elements_csv(os.path.join(workdir, "elements.csv"))
        sim = load_simulation_input(input_path)
    check(nodes_header == "x,y,ux,uy", f"nodes.csv header {nodes_header!r}")
    check(
        elements_header == "n0,n1,n2,stress",
        f"elements.csv header {elements_header!r}",
    )
    coords, u = nodes[:, :2], nodes[:, 2:]
    bca = apply_boundary_conditions(coords, sim.boundary_rules)
    md = sim.metadata
    k = oracle.sparse_stiffness(
        coords, tris, md.youngs_modulus, md.poisson_ratio, md.part_thickness
    )
    u_ref, f_ref, sigma_ref = oracle.sparse_solve(coords, tris, bca, md, k=k)
    known = bca.u_known.reshape(-1)
    # the CLI writes no forces: compare the reactions its u implies
    f_cli = (k @ u.reshape(-1))[known]
    s_ref = oracle.scalar_stress(sigma_ref)
    # the reference sign rule flips at sx + sy = 1: compare magnitudes, and
    # signs wherever sx + sy is clear of the flip by the f32 noise
    clear = np.abs(sigma_ref[:, 0] + sigma_ref[:, 1] - 1.0) > (
        1e-3 * np.abs(sigma_ref).max()
    )
    f32 = not jax.config.jax_enable_x64
    u_tol = U_TOL_F32 if f32 else U_TOL_F64
    s_tol = STRESS_TOL_F32 if f32 else U_TOL_F64
    record = {
        "phase": "1-cli",
        "nodes": int(coords.shape[0]),
        "elements": int(tris.shape[0]),
        "dtype": "float32" if f32 else "float64",
        "cg_iterations": int(iters.group(1)),
        "u_err": rel_err(u, u_ref),
        "f_err": rel_err(f_cli, f_ref.reshape(-1)[known]),
        "stress_err": rel_err(np.abs(stress), np.abs(s_ref)),
        "stress_sign_mismatch": int(
            (np.sign(stress) != np.sign(s_ref))[clear].sum()
        ),
        "true_rel_residual": oracle.true_relative_residual(k, bca, u),
        "u_tol": u_tol,
        "stress_tol": s_tol,
        "cold_s": times[0],
        "warm_s": times[1],
        "peak_bytes_in_use": peak_bytes(),
    }
    emit(record)
    check(record["u_err"] <= u_tol, f"CLI u error {record['u_err']:.2e}")
    check(record["f_err"] <= s_tol, f"CLI reaction error {record['f_err']:.2e}")
    check(
        record["stress_err"] <= s_tol,
        f"CLI stress error {record['stress_err']:.2e}",
    )
    check(record["stress_sign_mismatch"] == 0, "CLI stress signs differ")
    return record


def _solve_checked(name, mesh, bca, md, options, against_spsolve: bool):
    """compile_problem + two solves (cold, warm); the true f64 residual, and
    u against spsolve when asked. Returns (record, problem)."""
    from magnetite_tpu import oracle
    from magnetite_tpu.fem.solve import compile_problem

    t0 = time.perf_counter()
    problem = compile_problem(mesh, bca, md, options)
    result = problem.solve()
    cold = time.perf_counter() - t0
    t0 = time.perf_counter()
    problem.solve()
    warm = time.perf_counter() - t0
    k = sparse_k(mesh, md)
    record = {
        "phase": name,
        "nodes": int(mesh.num_nodes),
        "elements": int(mesh.num_elements),
        "operator": problem.mode,
        "preconditioner": problem.preconditioner,
        "refined": bool(problem.refine),
        "cg_iterations": int(result.iterations),
        "cg_rtol": float(options.cg_rtol),
        "solver_rel_residual": float(result.residual_rel),
        "true_rel_residual": oracle.true_relative_residual(k, bca, result.u),
        "true_rel_residual_tol": TRUE_REL_RESIDUAL,
        "cold_s": cold,
        "warm_s": warm,
        "peak_bytes_in_use": peak_bytes(),
    }
    if against_spsolve:
        u_ref, _, _ = oracle.sparse_solve(mesh.coords, mesh.tris, bca, md, k=k)
        record["u_err"] = rel_err(result.u, u_ref)
        record["u_tol"] = U_TOL_F64
    emit(record)
    check(
        record["true_rel_residual"] <= TRUE_REL_RESIDUAL,
        f"{name}: true relative residual {record['true_rel_residual']:.2e}",
    )
    if against_spsolve:
        check(record["u_err"] <= U_TOL_F64, f"{name}: u error {record['u_err']:.2e}")
    return record, problem


def phase_plate(sizes) -> None:
    """Phase 2: structured plate, stencil + multigrid + f64/f32 refinement."""
    from magnetite_tpu.config import SolverOptions

    opts = SolverOptions(dtype="float32", cg_rtol=1e-8)
    mesh, bca = structured_plate(*sizes["plate"])
    record, problem = _solve_checked(
        "2-plate", mesh, bca, metadata(0.01), opts, False
    )
    check(problem.mode == "stencil", f"plate took operator {problem.mode}")
    del problem
    read_stencil("2-plate", mesh, bca, sizes)
    small, small_bca = structured_plate(*sizes["plate_small"])
    _solve_checked(
        "2-plate-small", small, small_bca, metadata(0.01), opts, True
    )


def phase_delaunay(sizes) -> None:
    """Phase 3: Delaunay plate, DIA bands + f32 AMG V-cycle + f64 CG."""
    from magnetite_tpu.config import SolverOptions

    opts = SolverOptions(
        dtype="float32", cg_rtol=1e-8, refine="on", preconditioner="amg"
    )
    h = sizes["delaunay_h"]
    t0 = time.perf_counter()
    mesh, bca = delaunay_plate(h)
    emit({"phase": "3-delaunay-mesh", "elements": int(mesh.num_elements),
          "mesh_s": time.perf_counter() - t0})
    _, problem = _solve_checked(
        "3-delaunay", mesh, bca, metadata(h), opts, False
    )
    read_dia_and_transfers("3-delaunay", problem, mesh, sizes)
    del problem
    h = sizes["delaunay_small_h"]
    small, small_bca = delaunay_plate(h)
    _solve_checked("3-delaunay-small", small, small_bca, metadata(h), opts, True)


def _check_lanes(name, mesh, md, base, u_values, f_values, k_scales, result,
                 n_check):
    """Lanes spread over the batch against scipy direct solves; returns the
    worst u and von Mises errors."""
    from dataclasses import replace

    from magnetite_tpu import oracle
    from magnetite_tpu.bc import BCArrays

    k = sparse_k(mesh, md)
    b = u_values.shape[0]
    u_all = np.asarray(result.u)
    vm_all = np.asarray(result.von_mises)
    u_err = vm_err = 0.0
    for lane in np.linspace(0, b - 1, n_check).astype(int):
        s = float(k_scales[lane])
        bca = BCArrays(base.u_known, np.asarray(u_values[lane], np.float64),
                       np.asarray(f_values[lane], np.float64))
        md_b = replace(md, youngs_modulus=md.youngs_modulus * s)
        u_ref, _, sigma_ref = oracle.sparse_solve(
            mesh.coords, mesh.tris, bca, md_b, k=k * s
        )
        u_err = max(u_err, rel_err(u_all[lane], u_ref))
        vm_err = max(vm_err, rel_err(vm_all[lane], von_mises(sigma_ref)))
    check(u_err <= U_TOL_F32, f"{name}: lane u error {u_err:.2e}")
    check(vm_err <= STRESS_TOL_F32, f"{name}: lane von Mises error {vm_err:.2e}")
    return u_err, vm_err


def _timed_batches(solve, batches):
    """First call (compile) then the rest warm; syncs on the residuals."""
    times, results = [], []
    for args in batches:
        t0 = time.perf_counter()
        r = solve(*args)
        np.asarray(r.residual_norm)
        times.append(time.perf_counter() - t0)
        results.append(r)
    return times, results


def phase_sweeps(sizes) -> None:
    """Phase 4: 4,096-lane load sweeps, structured and unstructured."""
    from magnetite_tpu.meshing.generators import rect_mesh, tensile_bcs_for_rect
    from magnetite_tpu.parallel.sweep import (
        compile_sweep,
        compile_unstructured_sweep,
    )

    b = sizes["lanes"]
    mesh = rect_mesh(*sizes["sweep_rect"], width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    md = metadata(0.05)
    right = np.isclose(mesh.coords[:, 0], 2.0)

    def batch(seed):
        rng = np.random.default_rng(seed)
        u = np.tile(base.u_value[None], (b, 1, 1)).astype(np.float32)
        u[:, right, 0] = rng.uniform(0.005, 0.02, b).astype(np.float32)[:, None]
        f = np.zeros((b, mesh.num_nodes, 2), dtype=np.float32)
        return u, f, rng.uniform(0.5, 2.0, b)

    iters = 20
    t0 = time.perf_counter()
    compiled = compile_sweep(mesh, base, md, iterations=iters)
    setup_s = time.perf_counter() - t0
    batches = [batch(s) for s in (0, 1)]
    times, results = _timed_batches(compiled.solve, batches)
    rel = np.asarray(results[1].residual_norm) / np.asarray(results[1].rhs_norm)
    u_err, vm_err = _check_lanes(
        "4-sweep", mesh, md, base, *batches[1], results[1],
        sizes["check_lanes"],
    )
    emit({
        "phase": "4-sweep", "lanes": b, "nodes": int(mesh.num_nodes),
        "elements": int(mesh.num_elements), "iterations": iters,
        "rel_residual_max": float(rel.max()), "lane_u_err": u_err,
        "lane_vm_err": vm_err, "u_tol": U_TOL_F32, "vm_tol": STRESS_TOL_F32,
        "setup_s": setup_s, "cold_s": times[0], "warm_s": times[1],
        "solves_per_s": b / times[1], "peak_bytes_in_use": peak_bytes(),
    })
    del compiled, results

    h = sizes["sweep_h"]
    mesh, base = delaunay_plate(h)
    md = metadata(h)

    def factors(seed):
        rng = np.random.default_rng(seed)
        return (rng.uniform(0.5, 2.0, b).astype(np.float32),
                np.ones(b, dtype=np.float32), rng.uniform(0.5, 2.0, b))

    iters = 25
    t0 = time.perf_counter()
    compiled = compile_unstructured_sweep(
        mesh, base, md, iterations=iters, refined=False
    )
    setup_s = time.perf_counter() - t0
    batches = [factors(s) for s in (0, 1)]
    times, results = _timed_batches(compiled.solve_factors, batches)
    uf, ff, ks = batches[1]
    u_values = base.u_value.astype(np.float32)[None] * uf[:, None, None]
    f_values = base.f_value.astype(np.float32)[None] * ff[:, None, None]
    rel = np.asarray(results[1].residual_norm) / np.asarray(results[1].rhs_norm)
    u_err, vm_err = _check_lanes(
        "4-unstructured-sweep", mesh, md, base, u_values, f_values, ks,
        results[1], sizes["check_lanes"],
    )
    emit({
        "phase": "4-unstructured-sweep", "lanes": b,
        "nodes": int(mesh.num_nodes), "elements": int(mesh.num_elements),
        "iterations": iters, "rel_residual_max": float(rel.max()),
        "lane_u_err": u_err, "lane_vm_err": vm_err, "u_tol": U_TOL_F32,
        "vm_tol": STRESS_TOL_F32, "setup_s": setup_s, "cold_s": times[0],
        "warm_s": times[1], "solves_per_s": b / times[1],
        "peak_bytes_in_use": peak_bytes(),
    })
    read_lane_dia("4-unstructured-sweep", compiled, b, sizes)


def phase_four_cards(devices, sizes) -> None:
    """The sharded paths on four devices, each against a single-device run
    in this process and against the f64 reference."""
    from jax.sharding import Mesh

    from magnetite_tpu import oracle
    from magnetite_tpu.config import SolverOptions
    from magnetite_tpu.fem.solve import solve_system
    from magnetite_tpu.parallel.sweep import compile_unstructured_sweep

    devs = np.array(devices[:4])
    check(devs.size == 4, f"four devices needed, got {devs.size}")
    # 1e-10: the one-device and the sharded solve stop at different
    # iterates, and their u differ by about what cg_rtol leaves
    opts = SolverOptions(dtype="float32", cg_rtol=1e-10, refine="on")
    h = sizes["four_delaunay_h"]
    cases = [
        ("four-delaunay-1d", delaunay_plate(h), metadata(h),
         Mesh(devs, ("shard",))),
        ("four-plate-1d", structured_plate(*sizes["four_plate"]),
         metadata(0.01), Mesh(devs, ("shard",))),
        ("four-plate-2x2", structured_plate(*sizes["four_plate"]),
         metadata(0.01), Mesh(devs.reshape(2, 2), ("rows", "cols"))),
    ]
    for name, (mesh, bca), md, device_mesh in cases:
        single = solve_system(mesh, bca, md, opts)
        t0 = time.perf_counter()
        sharded = solve_system(mesh, bca, md, opts, device_mesh=device_mesh)
        cold = time.perf_counter() - t0
        k = sparse_k(mesh, md)
        u_ref, f_ref, _ = oracle.sparse_solve(
            mesh.coords, mesh.tris, bca, md, k=k
        )
        record = {
            "phase": name,
            "layout": "x".join(str(s) for s in device_mesh.devices.shape),
            "nodes": int(mesh.num_nodes),
            "elements": int(mesh.num_elements),
            "cg_iterations": int(sharded.iterations),
            "cg_iterations_single": int(single.iterations),
            "true_rel_residual": oracle.true_relative_residual(
                k, bca, sharded.u
            ),
            "u_err_vs_single": rel_err(sharded.u, single.u),
            "stress_err_vs_single": rel_err(sharded.stress, single.stress),
            "u_err": rel_err(sharded.u, u_ref),
            "u_tol": U_TOL_F64,
            "cold_s": cold,
            "peak_bytes_in_use": peak_bytes(),
        }
        emit(record)
        check(
            record["true_rel_residual"] <= TRUE_REL_RESIDUAL,
            f"{name}: true relative residual {record['true_rel_residual']:.2e}",
        )
        for key, tol in (("u_err_vs_single", U_TOL_F64), ("u_err", U_TOL_F64),
                         ("stress_err_vs_single", STRESS_TOL_REFINED)):
            check(record[key] <= tol, f"{name}: {key} {record[key]:.2e}")

    b = sizes["lanes"]
    h = sizes["sweep_h"]
    mesh, base = delaunay_plate(h)
    md = metadata(h)
    rng = np.random.default_rng(3)
    args = (rng.uniform(0.5, 2.0, b).astype(np.float32),
            np.ones(b, dtype=np.float32), rng.uniform(0.5, 2.0, b))
    single = compile_unstructured_sweep(
        mesh, base, md, iterations=25, refined=False
    ).solve_factors(*args)
    t0 = time.perf_counter()
    sharded_sweep = compile_unstructured_sweep(
        mesh, base, md, iterations=25, refined=False,
        device_mesh=Mesh(devs, ("lanes",)),
    )
    result = sharded_sweep.solve_factors(*args)
    cold = time.perf_counter() - t0
    check(
        not result.u.sharding.is_fully_replicated, "sweep lost lane sharding"
    )
    u_values = base.u_value.astype(np.float32)[None] * args[0][:, None, None]
    f_values = np.zeros_like(u_values)
    u_err, vm_err = _check_lanes(
        "four-sweep", mesh, md, base, u_values, f_values, args[2], result,
        sizes["check_lanes"],
    )
    record = {
        "phase": "four-sweep-lanes", "lanes": b, "nodes": int(mesh.num_nodes),
        "u_err_vs_single": rel_err(result.u, single.u),
        "lane_u_err": u_err, "lane_vm_err": vm_err, "u_tol": U_TOL_F32,
        "cold_s": cold, "peak_bytes_in_use": peak_bytes(),
    }
    emit(record)
    # the same f32 math on each lane, but XLA may order the reductions of
    # the two programs differently, and a fixed-budget f32 CG carries such
    # rounding into u up to its own f32 error (1.2e-4 apart on four H100s,
    # each within 2.6e-4 of the f64 solve): the f32 bar applies
    check(
        record["u_err_vs_single"] <= U_TOL_F32,
        f"sharded sweep diverges: {record['u_err_vs_single']:.2e}",
    )


def main(argv=None) -> int:
    import argparse

    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument(
        "--four-cards", action="store_true",
        help="run only the sharded paths, on four GPUs",
    )
    args = parser.parse_args(argv)

    import jax

    try:
        device = phase_device(args.four_cards)
    except SmokeFailure as err:
        print(f"chip_smoke: {err}", file=sys.stderr)
        return 2
    sizes = FULL
    if args.four_cards:
        jax.config.update("jax_enable_x64", True)
        phase_four_cards(jax.devices(), sizes)
    else:
        phase_cli(sizes)  # before x64: the CLI's own dtype rule decides
        jax.config.update("jax_enable_x64", True)
        phase_plate(sizes)
        phase_delaunay(sizes)
        phase_sweeps(sizes)
    emit(
        {
            "ok": True,
            "device": {
                "platform": device["platform"],
                "kind": device["device_kind"],
                "count": device["device_count"],
            },
        }
    )
    return 0


if __name__ == "__main__":
    sys.exit(main())
