"""Benchmark harness. Prints ONE JSON line.

Headline: linkedin-logo example (the reference's only published number:
0.286 s solve on a MacBook Air, reference readme.md:28) -- full device
pipeline (element stiffness + band assembly + preconditioned CG + stress
recovery) in ONE jit call on one GPU. Extras:

  linkedin_fine_* -- the same example at 4x finer characteristic length
              (mesh-fineness sensitivity next to the headline number).
  plate_*  -- 1M-element structured plate-with-hole, mixed-precision
              refined solve to 1e-8 RELATIVE residual (BASELINE.json north
              star), with the relative residual reported.
  plate4m_* -- the 4M-element scaling point (README claim, recorded).
  unstructured_* -- ~1M-element DELAUNAY-meshed plate (arbitrary-geometry
              path): DIA bands + smoothed-aggregation AMG, f64 CG with the
              f32 V-cycle, to 1e-8 relative.
  spmv_*   -- stencil SpMV roofline: effective GB/s of the XLA stencil
              matvec, measured dispatch-free (scan-length slope: time L2
              and L1 chained matvecs inside one jit, divide the
              difference), as a share of the card's peak bandwidth
              (HBM_PEAK_GBPS; no share for a card not in the table).
  sweep_*  -- 4096-variant load sweep (shared multigrid hierarchy).
  material_sweep_* -- 4096-variant TRUE material sweep: per-lane
              (E, nu, t) via basis stencils, exact per-lane multigrid.
  unstructured_sweep_* -- 4096-variant load sweep on a DELAUNAY mesh
              (shared smoothed-aggregation AMG hierarchy, exact per-lane
              k-scaling; TRUE relative residuals).
  unstructured_material_sweep_* -- 4096 TRUE (E, nu, t) variants on a
              delaunay mesh: basis DIA bands + basis AMG hierarchy.
  unstructured_resumed_* -- the checkpoint-resume path (persist.py):
              what a CLI re-run with --load-case pays before solving.

Timing notes: timed runs keep inputs AND outputs on device and sync on a
scalar; the SpMV numbers come from the slope method, which cancels the
dispatch cost exactly. Everything runs in this one process (a second JAX
process on the card would fail for want of memory), and the bench fails when
JAX finds no GPU.
"""

from __future__ import annotations

import json
import time

import numpy as np

# Peak device-memory bandwidth in GB/s by jax `device_kind`, from NVIDIA's
# H100 data sheet: SXM5 80 GB HBM3 3.35 TB/s, PCIe 80 GB HBM2e 2.0 TB/s.
# A card not listed gets no roofline share: no peak is assumed for it.
HBM_PEAK_GBPS = {
    "NVIDIA H100 80GB HBM3": 3350.0,
    "NVIDIA H100 PCIe": 2000.0,
}


def peak_share(gbps: float, device_kind: str):
    """gbps as a share of the card's peak bandwidth, or None when the card
    is not in HBM_PEAK_GBPS."""
    peak = HBM_PEAK_GBPS.get(device_kind)
    return None if peak is None else gbps / peak


def slope_seconds(step, x0, args=(), l1: int = 100, l2: int = 700,
                  repeats: int = 3) -> float:
    """Seconds per application of `step(x, *args) -> x` by the scan-length
    slope: time jitted chains of l1 and l2 applications (each the minimum
    of `repeats` warm runs, synced on a scalar) and divide the difference
    by l2 - l1, which cancels dispatch and sync costs. The per-iteration
    cost of the loop itself stays in."""
    import jax
    import jax.numpy as jnp

    def chain(length):
        @jax.jit
        def run(x, *a):
            def body(v, _):
                return step(v, *a), None

            v, _ = jax.lax.scan(body, x, None, length=length)
            return jnp.sum(v)

        float(run(x0, *args))  # compile + warm
        best = float("inf")
        for _ in range(repeats):
            t0 = time.perf_counter()
            float(run(x0, *args))
            best = min(best, time.perf_counter() - t0)
        return best

    return (chain(l2) - chain(l1)) / (l2 - l1)


def _bench_jax_config():
    """x64 ON: the refined solves use f64 operators/residuals (hot loops
    stay f32); the persistent compile cache keeps recompiles off repeat
    runs."""
    import jax

    from magnetite_tpu.utils.jaxcache import enable_persistent_cache

    jax.config.update("jax_enable_x64", True)
    enable_persistent_cache()


def _sync_scalar(out):
    return float(np.asarray(out[5]))  # iters (tiny transfer forces sync)


def _time_device_solve(problem, repeats):
    out = problem.solve_device()
    _sync_scalar(out)
    times = []
    for _ in range(repeats):
        t0 = time.perf_counter()
        out = problem.solve_device()
        _sync_scalar(out)
        times.append(time.perf_counter() - t0)
    # min: host-side jitter only ever adds time
    return float(np.min(times)), out


def _plate_problem(nr, nt):
    from magnetite_tpu.bc import BCArrays
    from magnetite_tpu.meshing.generators import plate_with_hole_mesh

    mesh = plate_with_hole_mesh(nr, nt)
    n = mesh.num_nodes
    coords = mesh.coords
    u_known = np.zeros((n, 2), dtype=bool)
    u_value = np.zeros((n, 2))
    left = np.isclose(coords[:, 0], coords[:, 0].min())
    right = np.isclose(coords[:, 0], coords[:, 0].max())
    u_known[left] = True
    u_known[right, 0] = True
    u_value[right, 0] = 0.01
    bca = BCArrays(u_known=u_known, u_value=u_value, f_value=np.zeros((n, 2)))
    return mesh, bca


def bench_linkedin(extras):
    from magnetite_tpu.config import SolverOptions, load_simulation_input
    from magnetite_tpu.fem.solve import compile_problem
    from magnetite_tpu.meshing import runner

    ex = "/root/reference/examples/linkedin-logo"
    sim = load_simulation_input(f"{ex}/input.json")
    mesh, bca = runner.run(
        [f"{ex}/linkedin.svg"], sim, backend="delaunay", log=lambda m: None
    )
    problem = compile_problem(
        mesh, bca, sim.metadata,
        SolverOptions(dtype="float32", cg_rtol=1e-6),
    )
    t, out = _time_device_solve(problem, repeats=9)
    extras["linkedin_nodes"] = mesh.num_nodes
    extras["linkedin_elements"] = mesh.num_elements
    extras["linkedin_cg_iters"] = int(np.asarray(out[5]))
    extras["linkedin_operator"] = problem.mode
    return t


def bench_linkedin_fine(extras):
    """linkedin-logo at 4x finer characteristic length (~16x the elements):
    quantifies mesh-fineness sensitivity next to the headline number (the
    reference's 0.286 s is on an unspecified 'pretty fine' gmsh mesh)."""
    from dataclasses import replace

    from magnetite_tpu.config import SolverOptions, load_simulation_input
    from magnetite_tpu.fem.solve import compile_problem
    from magnetite_tpu.meshing import runner

    ex = "/root/reference/examples/linkedin-logo"
    sim = load_simulation_input(f"{ex}/input.json")
    md = replace(
        sim.metadata,
        characteristic_length_min=sim.metadata.characteristic_length_min / 4,
        characteristic_length_max=sim.metadata.characteristic_length_max / 4,
    )
    sim = replace(sim, metadata=md)
    mesh, bca = runner.run(
        [f"{ex}/linkedin.svg"], sim, backend="delaunay", log=lambda m: None
    )
    problem = compile_problem(
        mesh, bca, sim.metadata,
        SolverOptions(dtype="float32", cg_rtol=1e-6),
    )
    t, out = _time_device_solve(problem, repeats=5)
    extras["linkedin_fine_nodes"] = mesh.num_nodes
    extras["linkedin_fine_elements"] = mesh.num_elements
    extras["linkedin_fine_cg_iters"] = int(np.asarray(out[5]))
    extras["linkedin_fine_operator"] = problem.mode
    extras["linkedin_fine_preconditioner"] = problem.preconditioner
    extras["linkedin_fine_solve_s"] = round(t, 4)


def bench_unstructured_1m(extras):
    """~1M-element DELAUNAY-meshed plate-with-hole to 1e-8 relative.

    The reference's actual use case at scale: arbitrary geometry -> built-in
    mesher -> banded DIA operator + smoothed-aggregation AMG -> f64 CG with
    the f32 V-cycle preconditioner (SolverOptions refine='on'). This is the
    unstructured counterpart of bench_plate_1m's generator-grid solve."""
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import (
        BoundaryRegion,
        BoundaryRule,
        BoundaryTarget,
        ModelMetadata,
        SolverOptions,
    )
    from magnetite_tpu.fem.solve import compile_problem
    from magnetite_tpu.meshing.delaunay_backend import triangulate

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    h = 0.00258  # ~1M elements over the 2.88-unit^2 domain
    t0 = time.perf_counter()
    mesh = triangulate([outer, hole], 0.0, h)
    extras["unstructured_mesh_gen_s"] = round(time.perf_counter() - t0, 2)
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
    bca = apply_boundary_conditions(mesh.coords, rules)
    metadata = ModelMetadata(69e9, 0.33, 0.5, 0.0, h)

    t0 = time.perf_counter()
    problem = compile_problem(
        mesh,
        bca,
        metadata,
        SolverOptions(
            dtype="float32", cg_rtol=1e-8, refine="on",
            keep_operator_host=True,  # save_operator feeds the resume leg
        ),
    )
    extras["unstructured_prep_s"] = round(time.perf_counter() - t0, 2)
    extras["unstructured_amg_setup_s"] = round(
        problem.timings.get("amg_setup_s", 0.0), 2
    )
    extras["unstructured_assemble_s"] = round(
        problem.timings.get("assemble_s", 0.0), 2
    )
    # host build vs upload split
    extras["unstructured_amg_build_s"] = round(
        problem.timings.get("amg_build_s", 0.0), 2
    )
    extras["unstructured_amg_upload_s"] = round(
        problem.timings.get("amg_upload_s", 0.0), 2
    )
    extras["unstructured_assemble_build_s"] = round(
        problem.timings.get("assemble_build_s", 0.0), 2
    )
    extras["unstructured_assemble_upload_s"] = round(
        problem.timings.get("assemble_upload_s", 0.0), 2
    )
    # overlap diagnostics: issue (put dispatch) vs the single end sync,
    # plus the exact payload
    extras["unstructured_prep_sync_s"] = round(
        problem.timings.get("prep_sync_s", 0.0), 2
    )
    extras["unstructured_bytes_shipped"] = int(
        problem.timings.get("amg_upload_bytes", 0)
        + problem.timings.get("assemble_upload_bytes", 0)
    )

    t, out = _time_device_solve(problem, repeats=3)
    resnorm = float(np.asarray(out[6]))
    bnorm = float(np.asarray(out[8]))
    extras["unstructured_elements"] = mesh.num_elements
    extras["unstructured_nodes"] = mesh.num_nodes
    extras["unstructured_solve_s"] = round(t, 3)
    extras["unstructured_cg_iters"] = int(np.asarray(out[5]))
    extras["unstructured_operator"] = problem.mode
    extras["unstructured_preconditioner"] = problem.preconditioner
    extras["unstructured_residual_rel"] = resnorm / bnorm

    # the amortized path: checkpoint mesh + AMG hierarchy + assembled
    # operator (persist.py), then re-compile from the checkpoints -- what a
    # CLI re-run with --load-case pays (it auto-loads the .amg/.op siblings).
    import os
    import tempfile

    from magnetite_tpu.persist import save_amg, save_case, save_operator

    with tempfile.TemporaryDirectory() as tmp:
        case = os.path.join(tmp, "case.npz")
        save_case(case, mesh, bca, metadata=metadata)
        save_amg(case + ".amg.npz", problem.amg_setup)
        save_operator(case + ".op.npz", problem)
        del problem
        _unstructured_resumed(case, extras)


def _unstructured_resumed(case: str, extras):
    """The checkpoint-resume path, in this process."""
    from magnetite_tpu.config import SolverOptions
    from magnetite_tpu.fem.solve import compile_problem
    from magnetite_tpu.persist import load_amg, load_case, load_operator

    t0 = time.perf_counter()
    mesh_r, bca_r, md_r, structure_r = load_case(case)
    amg_r = load_amg(case + ".amg.npz")
    op_r = load_operator(case + ".op.npz")
    problem_r = compile_problem(
        mesh_r,
        bca_r,
        md_r,
        SolverOptions(dtype="float32", cg_rtol=1e-8, refine="on"),
        structure=structure_r,
        amg_setup=amg_r,
        operator_cache=op_r,
    )
    extras["unstructured_resumed_prep_s"] = round(time.perf_counter() - t0, 2)
    extras["unstructured_resumed_host_s"] = round(
        problem_r.timings.get("structure_s", 0.0)
        + problem_r.timings.get("amg_build_s", 0.0)
        + problem_r.timings.get("assemble_build_s", 0.0),
        2,
    )
    # upload wall = put-issue time + the single end sync (the puts stream
    # concurrently -- compile_problem overlaps them with its host work)
    extras["unstructured_resumed_upload_s"] = round(
        problem_r.timings.get("upload_s", 0.0)
        + problem_r.timings.get("amg_issue_s", 0.0)
        + problem_r.timings.get("assemble_issue_s", 0.0)
        + problem_r.timings.get("prep_sync_s", 0.0),
        2,
    )
    extras["unstructured_resumed_bytes_shipped"] = int(
        problem_r.timings.get("amg_upload_bytes", 0)
        + problem_r.timings.get("assemble_upload_bytes", 0)
    )
    # the same resume a second time (host file caches warm)
    t0 = time.perf_counter()
    mesh_w, bca_w, md_w, structure_w = load_case(case)
    problem_w = compile_problem(
        mesh_w,
        bca_w,
        md_w,
        SolverOptions(dtype="float32", cg_rtol=1e-8, refine="on"),
        structure=structure_w,
        amg_setup=load_amg(case + ".amg.npz"),
        operator_cache=load_operator(case + ".op.npz"),
    )
    extras["unstructured_resumed_warm_prep_s"] = round(
        time.perf_counter() - t0, 2
    )
    del problem_w

    t_r, out_r = _time_device_solve(problem_r, repeats=1)
    extras["unstructured_resumed_solve_s"] = round(t_r, 3)


def bench_unstructured_2m(extras):
    """~2M-element DELAUNAY scale point: AMG + symmetric-half upload at 2x
    the arbitrary-geometry flagship, iteration counts still
    mesh-independent."""
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import (
        BoundaryRegion,
        BoundaryRule,
        BoundaryTarget,
        ModelMetadata,
        SolverOptions,
    )
    from magnetite_tpu.fem.solve import compile_problem
    from magnetite_tpu.meshing.delaunay_backend import triangulate

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    h = 0.00182  # ~2M elements over the 2.88-unit^2 domain
    t0 = time.perf_counter()
    mesh = triangulate([outer, hole], 0.0, h)
    extras["unstructured2m_mesh_gen_s"] = round(time.perf_counter() - t0, 2)
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
    bca = apply_boundary_conditions(mesh.coords, rules)
    metadata = ModelMetadata(69e9, 0.33, 0.5, 0.0, h)

    t0 = time.perf_counter()
    problem = compile_problem(
        mesh,
        bca,
        metadata,
        SolverOptions(dtype="float32", cg_rtol=1e-8, refine="on"),
    )
    extras["unstructured2m_prep_s"] = round(time.perf_counter() - t0, 2)
    extras["unstructured2m_amg_build_s"] = round(
        problem.timings.get("amg_build_s", 0.0), 2
    )
    extras["unstructured2m_assemble_build_s"] = round(
        problem.timings.get("assemble_build_s", 0.0), 2
    )
    extras["unstructured2m_prep_sync_s"] = round(
        problem.timings.get("prep_sync_s", 0.0), 2
    )
    extras["unstructured2m_bytes_shipped"] = int(
        problem.timings.get("amg_upload_bytes", 0)
        + problem.timings.get("assemble_upload_bytes", 0)
    )

    t, out = _time_device_solve(problem, repeats=2)
    resnorm = float(np.asarray(out[6]))
    bnorm = float(np.asarray(out[8]))
    extras["unstructured2m_elements"] = mesh.num_elements
    extras["unstructured2m_nodes"] = mesh.num_nodes
    extras["unstructured2m_solve_s"] = round(t, 3)
    extras["unstructured2m_cg_iters"] = int(np.asarray(out[5]))
    extras["unstructured2m_operator"] = problem.mode
    extras["unstructured2m_residual_rel"] = resnorm / bnorm


def bench_plate_4m(extras):
    """4M-element structured plate (the README scaling claim, recorded)."""
    from magnetite_tpu.config import ModelMetadata, SolverOptions
    from magnetite_tpu.fem.solve import compile_problem

    t0 = time.perf_counter()
    mesh, bca = _plate_problem(1024, 2048)  # 4,194,304 elements
    extras["plate4m_mesh_gen_s"] = round(time.perf_counter() - t0, 2)
    metadata = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.01)
    problem = compile_problem(
        mesh, bca, metadata, SolverOptions(dtype="float32", cg_rtol=1e-8)
    )
    t, out = _time_device_solve(problem, repeats=1)
    resnorm = float(np.asarray(out[6]))
    bnorm = float(np.asarray(out[8]))
    extras["plate4m_elements"] = mesh.num_elements
    extras["plate4m_solve_s"] = round(t, 3)
    extras["plate4m_inner_iters"] = int(np.asarray(out[5]))
    extras["plate4m_residual_rel"] = resnorm / bnorm


def bench_plate_1m(extras):
    """1M elements, assembled + refined to 1e-8 relative residual on device."""
    from magnetite_tpu.config import ModelMetadata, SolverOptions
    from magnetite_tpu.fem.solve import compile_problem

    t0 = time.perf_counter()
    mesh, bca = _plate_problem(512, 1024)  # 1,048,576 elements
    extras["plate_mesh_gen_s"] = round(time.perf_counter() - t0, 2)
    metadata = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.01)

    t0 = time.perf_counter()
    problem = compile_problem(
        mesh, bca, metadata, SolverOptions(dtype="float32", cg_rtol=1e-8)
    )
    extras["plate_prep_s"] = round(time.perf_counter() - t0, 2)

    t, out = _time_device_solve(problem, repeats=3)
    iters = int(np.asarray(out[5]))
    resnorm = float(np.asarray(out[6]))
    bnorm = float(np.asarray(out[8]))
    n = mesh.num_nodes
    extras["plate_elements"] = mesh.num_elements
    extras["plate_nodes"] = n
    extras["plate_solve_s"] = round(t, 3)
    extras["plate_inner_iters"] = iters
    extras["plate_operator"] = problem.mode
    extras["plate_preconditioner"] = problem.preconditioner
    extras["plate_refined"] = problem.refine
    extras["plate_residual_abs"] = resnorm
    extras["plate_rhs_norm"] = bnorm
    extras["plate_residual_rel"] = resnorm / bnorm
    extras["plate_mdof_per_s"] = round(2 * n / t / 1e6, 2)
    return mesh, bca, metadata


def bench_spmv_roofline(extras, plate):
    """Stencil SpMV GB/s via the scan-length slope method."""
    import jax
    import jax.numpy as jnp
    from magnetite_tpu.fem.solve import _grid, _reduce_stencil
    from magnetite_tpu.fem.stencil import (
        assemble_stencil_structured,
        stencil_matvec,
    )

    mesh, bca, metadata = plate
    rows, cols = mesh.grid_shape
    wrap = mesh.wrap_cols

    @jax.jit
    def build(coords, free):
        raw = assemble_stencil_structured(
            coords,
            jnp.float32(metadata.youngs_modulus),
            jnp.float32(metadata.poisson_ratio),
            jnp.float32(metadata.part_thickness),
            rows,
            cols,
            wrap,
        )
        return _reduce_stencil(raw, free, wrap)

    coords = jnp.asarray(mesh.coords, jnp.float32)
    free = _grid(jnp.asarray(~bca.u_known, jnp.float32), rows, cols)
    stencil = build(coords, free)
    u0 = jnp.asarray(
        np.random.default_rng(0).standard_normal((2, rows, cols)), jnp.float32
    )

    # scaled by 1/(max absolute row sum) so the chained field stays finite
    scale = jnp.float32(1.0 / float(jnp.abs(stencil).sum(axis=(0, 2)).max()))
    bytes_per_mv = (36 + 2 + 2) * rows * cols * 4
    t_mv = slope_seconds(
        lambda v, st: stencil_matvec(st, v, wrap) * scale, u0, (stencil,)
    )
    gbps = bytes_per_mv / t_mv / 1e9
    extras["spmv_ms"] = round(t_mv * 1e3, 4)
    extras["spmv_gbps"] = round(gbps, 1)
    extras["spmv_roofline_frac"] = peak_share(
        gbps, jax.devices()[0].device_kind
    )


def bench_sweep(extras):
    """4096 load variants of the tensile plate in one batched solve
    (BASELINE.json configs[4]): shared-hierarchy multigrid preconditions
    every lane (~1.4e-6 true relative residual in 20 lockstep iterations;
    block-Jacobi needed 300+ for 3e-4). Warm batches carry FRESH inputs --
    the interactive design-exploration serving pattern."""
    from magnetite_tpu.config import ModelMetadata
    from magnetite_tpu.meshing.generators import rect_mesh, tensile_bcs_for_rect
    from magnetite_tpu.parallel.sweep import compile_sweep

    mesh = rect_mesh(64, 32, width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    metadata = ModelMetadata(69e9, 0.33, 0.5, 0.0, 0.05)
    b = 4096
    right = np.isclose(mesh.coords[:, 0], 2.0)

    def batch(seed):
        rng = np.random.default_rng(seed)
        pulls = rng.uniform(0.005, 0.02, b).astype(np.float32)
        u_values = np.tile(base.u_value[None], (b, 1, 1)).astype(np.float32)
        u_values[:, right, 0] = pulls[:, None]
        f_values = np.zeros((b, mesh.num_nodes, 2), dtype=np.float32)
        return u_values, f_values, rng.uniform(0.5, 2.0, b)

    iters = 20
    t0 = time.perf_counter()
    compiled = compile_sweep(mesh, base, metadata, iterations=iters)
    u_values, f_values, k_scales = batch(0)
    result = compiled.solve(u_values, f_values, k_scales)
    float(np.asarray(result.residual_norm[0]))
    t_total = time.perf_counter() - t0  # setup + first batch (incl. compile)

    times = []
    for seed in (1, 2, 3, 4):
        u_values, f_values, k_scales = batch(seed)
        t0 = time.perf_counter()
        result = compiled.solve(u_values, f_values, k_scales)
        rel = np.asarray(result.residual_norm) / np.asarray(result.rhs_norm)
        times.append(time.perf_counter() - t0)
    t = float(np.min(times))  # min: host-side jitter only ever adds time
    extras["sweep_variants"] = b
    extras["sweep_impl"] = "stencil_mg_lanes"  # compile_sweep's only mode
    extras["sweep_iterations"] = iters
    extras["sweep_mesh_elements"] = mesh.num_elements
    extras["sweep_warm_s"] = round(t, 3)
    extras["sweep_solves_per_s"] = round(b / t)
    extras["sweep_first_s"] = round(t_total, 2)
    extras["sweep_rel_residual_max"] = float(rel.max())


def bench_material_sweep(extras):
    """4096-variant TRUE material sweep: per-lane (E, nu, t) via the
    basis-stencil decomposition with exact per-lane multigrid
    (parallel/sweep.compile_material_sweep)."""
    from magnetite_tpu.meshing.generators import rect_mesh, tensile_bcs_for_rect
    from magnetite_tpu.parallel.sweep import compile_material_sweep

    mesh = rect_mesh(64, 32, width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    b = 4096
    iters = 20

    def batch(seed):
        rng = np.random.default_rng(seed)
        u_values = np.tile(base.u_value[None], (b, 1, 1)).astype(np.float32)
        f_values = np.zeros((b, mesh.num_nodes, 2), dtype=np.float32)
        return (
            u_values,
            f_values,
            rng.uniform(40e9, 250e9, b).astype(np.float32),
            rng.uniform(0.22, 0.38, b).astype(np.float32),
            rng.uniform(0.2, 1.0, b).astype(np.float32),
        )

    compiled = compile_material_sweep(mesh, base, iterations=iters)
    result = compiled.solve(*batch(0))
    float(np.asarray(result.residual_norm[0]))  # sync (compile included)

    times = []
    for seed in (1, 2, 3):
        args = batch(seed)
        t0 = time.perf_counter()
        result = compiled.solve(*args)
        rel = np.asarray(result.residual_norm) / np.asarray(result.rhs_norm)
        times.append(time.perf_counter() - t0)
    t = float(np.min(times))
    extras["material_sweep_variants"] = b
    extras["material_sweep_iterations"] = iters
    extras["material_sweep_warm_s"] = round(t, 3)
    extras["material_sweep_solves_per_s"] = round(b / t)
    extras["material_sweep_rel_residual_max"] = float(rel.max())


def bench_unstructured_sweep(extras):
    """4096-variant load sweep on a DELAUNAY mesh: one
    shared smoothed-aggregation AMG hierarchy preconditions every lane
    exactly (V((sK))^-1 = (1/s)V(K)^-1), f64 CG over the f32 V-cycle.
    Block-Jacobi lanes needed O(1/h) lockstep iterations here; AMG stays
    mesh-independent."""
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import (
        BoundaryRegion,
        BoundaryRule,
        BoundaryTarget,
        ModelMetadata,
    )
    from magnetite_tpu.meshing.delaunay_backend import triangulate
    from magnetite_tpu.parallel.sweep import compile_unstructured_sweep

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    h = 0.03  # ~5.6k nodes / 10.6k elements (f64 lane state fits HBM)
    mesh = triangulate([outer, hole], 0.0, h)
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
    base = apply_boundary_conditions(mesh.coords, rules)
    md = ModelMetadata(69e9, 0.33, 0.5, 0.0, h)
    b = 4096

    def batch(seed):
        """Per-lane pull magnitudes as LOAD FACTORS of the base BCs
        (pull = factor * 0.01 over [0.005, 0.02] -- the same variant set
        the dense batches carried as [B, N, 2] fields)."""
        rng = np.random.default_rng(seed)
        u_factors = rng.uniform(0.5, 2.0, b).astype(np.float32)
        f_factors = np.ones(b, dtype=np.float32)
        return u_factors, f_factors, rng.uniform(0.5, 2.0, b)

    iters = 25
    t0 = time.perf_counter()
    # refined=False: these lanes are displacement-driven, where pure-f32
    # converges to ~2e-6 TRUE relative residual (recorded below); the f64
    # default exists for force-driven lanes that hit the kappa*eps_f32 wall
    compiled = compile_unstructured_sweep(
        mesh, base, md, iterations=iters, refined=False
    )
    result = compiled.solve_factors(*batch(0))
    float(np.asarray(result.residual_norm[0]))
    t_total = time.perf_counter() - t0  # setup + first batch (incl. compile)

    times = []
    for seed in (1, 2, 3, 4):
        args = batch(seed)
        t0 = time.perf_counter()
        result = compiled.solve_factors(*args)
        rel = np.asarray(result.residual_norm) / np.asarray(result.rhs_norm)
        times.append(time.perf_counter() - t0)
    t = float(np.min(times))
    extras["unstructured_sweep_variants"] = b
    extras["unstructured_sweep_mesh_nodes"] = mesh.num_nodes
    extras["unstructured_sweep_mesh_elements"] = mesh.num_elements
    extras["unstructured_sweep_iterations"] = iters
    extras["unstructured_sweep_warm_s"] = round(t, 3)
    extras["unstructured_sweep_solves_per_s"] = round(b / t)
    extras["unstructured_sweep_first_s"] = round(t_total, 2)
    extras["unstructured_sweep_rel_residual_max"] = float(rel.max())

    # dense-field I/O datapoint: the same batch shipped as [B, N, 2]
    # host arrays through solve() -- isolates what the parametric API
    # saves in upload (the solve itself is identical)
    rng = np.random.default_rng(5)
    u_factors = rng.uniform(0.5, 2.0, b).astype(np.float32)
    u_values = (
        base.u_value.astype(np.float32)[None] * u_factors[:, None, None]
    )
    f_values = np.zeros((b, mesh.num_nodes, 2), dtype=np.float32)
    dense_args = (u_values, f_values, rng.uniform(0.5, 2.0, b))
    result = compiled.solve(*dense_args)  # compile the dense entry
    float(np.asarray(result.residual_norm[0]))
    t0 = time.perf_counter()
    result = compiled.solve(*dense_args)
    float(np.asarray(result.residual_norm[0]))
    extras["unstructured_sweep_dense_io_warm_s"] = round(
        time.perf_counter() - t0, 3
    )


def bench_unstructured_material_sweep(extras):
    """4096-variant TRUE (E, nu, t) sweep on a DELAUNAY mesh: three basis
    DIA band sets + the basis AMG hierarchy give every lane the exact
    V-cycle of its own material (fem/amg.build_amg_material_setup)."""
    from magnetite_tpu.bc import apply_boundary_conditions
    from magnetite_tpu.config import (
        BoundaryRegion,
        BoundaryRule,
        BoundaryTarget,
    )
    from magnetite_tpu.meshing.delaunay_backend import triangulate
    from magnetite_tpu.parallel.sweep import (
        compile_unstructured_material_sweep,
    )

    outer = np.array([[0.0, 0.0], [3.0, 0.0], [3.0, 1.0], [0.0, 1.0]])
    hole = np.array([[1.3, 0.35], [1.7, 0.35], [1.7, 0.65], [1.3, 0.65]])
    h = 0.03  # matches bench_unstructured_sweep (HBM budget)
    mesh = triangulate([outer, hole], 0.0, h)
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
    base = apply_boundary_conditions(mesh.coords, rules)
    b = 4096
    iters = 30

    def batch(seed):
        """Unit load factors (every lane pulls the base 0.01) with
        per-lane (E, nu, t) -- the same variants the dense batches
        carried as [B, N, 2] fields, now as [B] vectors."""
        rng = np.random.default_rng(seed)
        ones = np.ones(b, dtype=np.float32)
        return (
            ones,
            ones,
            rng.uniform(40e9, 250e9, b).astype(np.float32),
            rng.uniform(0.22, 0.38, b).astype(np.float32),
            rng.uniform(0.2, 1.0, b).astype(np.float32),
        )

    t0 = time.perf_counter()
    # displacement-driven lanes: f32 CG suffices (see unstructured_sweep)
    compiled = compile_unstructured_material_sweep(
        mesh, base, iterations=iters, refined=False
    )
    result = compiled.solve_factors(*batch(0))
    float(np.asarray(result.residual_norm[0]))
    t_total = time.perf_counter() - t0

    times = []
    for seed in (1, 2, 3):
        args = batch(seed)
        t0 = time.perf_counter()
        result = compiled.solve_factors(*args)
        rel = np.asarray(result.residual_norm) / np.asarray(result.rhs_norm)
        times.append(time.perf_counter() - t0)
    t = float(np.min(times))
    extras["unstructured_material_sweep_variants"] = b
    extras["unstructured_material_sweep_mesh_nodes"] = mesh.num_nodes
    extras["unstructured_material_sweep_iterations"] = iters
    extras["unstructured_material_sweep_warm_s"] = round(t, 3)
    extras["unstructured_material_sweep_solves_per_s"] = round(b / t)
    extras["unstructured_material_sweep_first_s"] = round(t_total, 2)
    extras["unstructured_material_sweep_rel_residual_max"] = float(rel.max())


def main():
    import jax

    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"bench.py needs a GPU; JAX's first device is {dev}")
    _bench_jax_config()

    extras = {
        "platform": dev.platform,
        "device_kind": dev.device_kind,
        "device_count": len(jax.devices()),
    }

    def attempt(name, fn, *args):
        """Run one block; record its failure instead of losing the JSON.
        Returns (ok, result)."""
        try:
            return True, fn(*args)
        except Exception as err:
            extras[f"{name}_error"] = f"{type(err).__name__}: {err}"
            # drop any device buffers the failed block still references
            # (an OOMed sweep otherwise starves every later block)
            import gc

            gc.collect()
            return False, None

    linkedin_t = bench_linkedin(extras)
    attempt("linkedin_fine", bench_linkedin_fine, extras)
    ok, plate = attempt("plate", bench_plate_1m, extras)
    if ok:
        attempt("spmv", bench_spmv_roofline, extras, plate)
    attempt("plate4m", bench_plate_4m, extras)
    attempt("sweep", bench_sweep, extras)
    attempt("material_sweep", bench_material_sweep, extras)
    attempt("unstructured_sweep", bench_unstructured_sweep, extras)
    attempt(
        "unstructured_material_sweep",
        bench_unstructured_material_sweep,
        extras,
    )
    attempt("unstructured", bench_unstructured_1m, extras)
    attempt("unstructured2m", bench_unstructured_2m, extras)

    baseline = 0.286  # reference readme.md:28
    print(
        json.dumps(
            {
                "metric": "linkedin_logo_device_pipeline_s",
                "value": round(linkedin_t, 5),
                "unit": "s",
                "vs_baseline": round(baseline / linkedin_t, 2),
                **extras,
            }
        )
    )


if __name__ == "__main__":
    main()
