"""Command-line interface.

Usage parity with the reference binary (src/main.rs:21-76):

    python -m magnetite_tpu.cli <input.json> <geometry files...>
        [--cmap CMAP] [--skip]

plus new flags of this rebuild: --backend {auto,gmsh,delaunay},
--precision {f32,f64,mixed}, --operator, --preconditioner, --save-plot
PATH, --out-dir DIR, --profile DIR, --von-mises. Errors print ``Received error: <stage> error: <msg>`` and
exit 1 (reference: src/main.rs:43-51).
"""

from __future__ import annotations

import argparse
import sys


def build_parser() -> argparse.ArgumentParser:
    parser = argparse.ArgumentParser(
        prog="magnetite-tpu",
        description="JAX 2D linear-elastic FEA solver",
    )
    parser.add_argument(
        "input_file", metavar="FILE", help="Input Json with boundary conditions"
    )
    parser.add_argument(
        "geometry_files",
        metavar="FILE",
        nargs="*",
        help="Geometry SVG or CSVs (omit when using --load-case)",
    )
    parser.add_argument(
        "-c",
        "--cmap",
        default="coolwarm",
        help="cmap for plot (default: coolwarm)",
    )
    parser.add_argument(
        "-s", "--skip", action="store_true", help="skip plot"
    )
    parser.add_argument(
        "--backend",
        choices=["auto", "gmsh", "delaunay"],
        default="auto",
        help="meshing backend (auto: gmsh if installed, else built-in)",
    )
    parser.add_argument(
        "--precision",
        choices=["f32", "f64", "mixed"],
        default=None,
        help="solve precision (default: f64 on CPU, f32 on the GPU); 'mixed' "
        "= f64 operator/residual with f32 inner solves (f64 accuracy at "
        "f32 iteration speed)",
    )
    parser.add_argument(
        "--save-plot", default=None, help="save the figure to this path"
    )
    parser.add_argument(
        "--out-dir", default=".", help="directory for nodes.csv/elements.csv"
    )
    parser.add_argument(
        "--von-mises",
        action="store_true",
        help="write true von Mises stress instead of the legacy scalar",
    )
    parser.add_argument(
        "--rtol", type=float, default=None, help="CG relative tolerance"
    )
    parser.add_argument(
        "--operator",
        choices=["auto", "stencil", "dia", "hybrid", "ell"],
        default=None,
        help="sparse operator format (default: auto-select per mesh)",
    )
    parser.add_argument(
        "--preconditioner",
        choices=["auto", "none", "jacobi", "block_jacobi", "multigrid", "amg"],
        default=None,
        help="CG preconditioner (default: auto -- multigrid on structured "
        "grids, smoothed-aggregation AMG on large unstructured meshes)",
    )
    parser.add_argument(
        "--profile",
        default=None,
        help="write a jax.profiler trace to this directory",
    )
    parser.add_argument(
        "--cg-progress",
        type=int,
        default=0,
        metavar="N",
        help="log CG iteration/residual every N iterations during the solve",
    )
    parser.add_argument(
        "--shard",
        action="store_true",
        help="run the solve + recovery sharded over every visible device "
        "(multi-chip pipeline; single-device runs produce identical output)",
    )
    parser.add_argument(
        "--shard-layout",
        default=None,
        metavar="RxC",
        help="device-mesh layout for --shard (implies it): 'auto' is a 1D "
        "mesh over every device; 'RxC' (e.g. '2x2') lays structured grids "
        "over a 2D rows x cols device grid",
    )
    parser.add_argument(
        "--save-case",
        default=None,
        help="checkpoint mesh+BCs to this npz after meshing",
    )
    parser.add_argument(
        "--load-case",
        default=None,
        help="resume from an npz checkpoint instead of meshing",
    )
    return parser


def entry(argv=None) -> None:
    import os

    args = build_parser().parse_args(argv)
    if args.shard_layout is not None:
        args.shard = True

    # Heavy imports deferred so --help stays fast.
    import jax

    from .config import SolverOptions, load_simulation_input
    from .meshing import runner
    from .post.csv_out import write_results
    from .utils.logging import stage, log

    sim = load_simulation_input(args.input_file)

    opt_kwargs = {}
    if args.precision == "f32":
        opt_kwargs["dtype"] = "float32"
    elif args.precision == "f64":
        jax.config.update("jax_enable_x64", True)
        opt_kwargs["dtype"] = "float64"
    elif args.precision == "mixed":
        jax.config.update("jax_enable_x64", True)
        opt_kwargs["dtype"] = "float32"
        opt_kwargs["refine"] = "on"
    elif jax.default_backend() == "cpu":
        # CPU default: full f64 accuracy. The accelerator default stays
        # f32: it was set where f64 was emulated, and is re-decided from
        # H100 measurements (ROADMAP S4).
        jax.config.update("jax_enable_x64", True)
        opt_kwargs["dtype"] = "float64"
    if args.rtol is not None:
        opt_kwargs["cg_rtol"] = args.rtol
    if args.cg_progress > 0:
        opt_kwargs["cg_progress_every"] = args.cg_progress
    if args.operator is not None:
        opt_kwargs["operator"] = args.operator
    if args.preconditioner is not None:
        opt_kwargs["preconditioner"] = args.preconditioner
    # the host copy of the assembled operator (~650 MB at 1M elements)
    # exists to feed persist.save_operator; skip it unless saving
    opt_kwargs["keep_operator_host"] = bool(args.save_case)
    options = SolverOptions(**opt_kwargs)

    profile_ctx = None
    if args.profile:
        profile_ctx = jax.profiler.trace(args.profile)
        profile_ctx.__enter__()

    try:
        if args.load_case:
            from .persist import load_case

            with stage("load-case"):
                mesh, bca, case_md, structure = load_case(args.load_case)
            log(
                f"info: resumed case from {args.load_case} "
                f"({mesh.num_nodes} nodes, {mesh.num_elements} elements)"
            )
            if case_md is not None and case_md != sim.metadata:
                log(
                    "warning: checkpoint metadata differs from the input "
                    "JSON; solving with the input JSON's material properties"
                )
        else:
            if not args.geometry_files:
                from .errors import InputError

                raise InputError(
                    "no geometry files given (or pass --load-case)"
                )
            with stage("mesh"):
                mesh, bca = runner.run(
                    args.geometry_files,
                    sim,
                    backend=args.backend,
                    options=options,
                    log=log,
                )
            structure = None
        if args.save_case:
            from .persist import save_case

            with stage("save-case"):
                save_case(args.save_case, mesh, bca, metadata=sim.metadata)
            log(f"info: checkpointed case to {args.save_case}")
        amg_setup = None
        if args.load_case and os.path.exists(args.load_case + ".amg.npz"):
            from .errors import InputError
            from .persist import load_amg

            try:
                with stage("load-amg"):
                    amg_setup = load_amg(args.load_case + ".amg.npz")
                log("info: loaded AMG hierarchy cache")
            except InputError as err:
                # the cache is purely an optimization: never fail the run
                log(f"warning: ignoring unreadable AMG cache ({err})")
        operator_cache = None
        # the sharded pipeline re-assembles shard-local operators, so the
        # single-chip assembly cache (~650 MB at 1M elements) would be
        # loaded only to be ignored
        if (
            args.load_case
            and not args.shard
            and os.path.exists(args.load_case + ".op.npz")
        ):
            from .errors import InputError
            from .persist import load_operator

            try:
                with stage("load-operator"):
                    operator_cache = load_operator(args.load_case + ".op.npz")
                log("info: loaded assembled-operator cache")
            except InputError as err:
                log(f"warning: ignoring unreadable operator cache ({err})")
        with stage("solve"):
            # `structure` is the checkpoint's block-ELL sparsity when
            # resuming; `amg_setup` the checkpoint's AMG hierarchy (both
            # skip their expensive host rebuilds)
            if args.shard:
                from .parallel.pipeline import (
                    compile_sharded_problem,
                    parse_device_mesh,
                )

                device_mesh = parse_device_mesh(args.shard_layout or "auto")
                layout = "x".join(
                    str(device_mesh.shape[a])
                    for a in device_mesh.axis_names
                )
                log(
                    f"info: sharding the solve over "
                    f"{len(jax.devices())} device(s) ({layout})"
                )
                problem = compile_sharded_problem(
                    mesh, bca, sim.metadata, options,
                    device_mesh=device_mesh, amg_setup=amg_setup,
                )
            else:
                from .fem.solve import compile_problem

                problem = compile_problem(
                    mesh, bca, sim.metadata, options,
                    structure=structure, amg_setup=amg_setup,
                    operator_cache=operator_cache,
                )
            result = problem.solve()
        # np.savez appends .npz to the CASE path; mirror that here so
        # `--load-case <case>.npz` finds the siblings at <case>.npz.amg.npz
        # / .op.npz
        case_path = (
            args.save_case
            if not args.save_case or args.save_case.endswith(".npz")
            else args.save_case + ".npz"
        )
        # `--load-case X --save-case X` is the standard refresh invocation;
        # when a sibling cache was loaded AND reused unchanged, rewriting
        # it would re-serialize ~650 MB (at 1M elements) for nothing
        resumed_same_case = bool(args.load_case) and case_path == args.load_case
        if args.save_case and problem.amg_setup is not None:
            if resumed_same_case and problem.amg_setup is amg_setup:
                log("info: AMG hierarchy cache is current; not rewriting")
            else:
                from .persist import save_amg

                with stage("save-amg"):
                    save_amg(case_path + ".amg.npz", problem.amg_setup)
                log(f"info: cached AMG hierarchy to {case_path}.amg.npz")
        if args.save_case and getattr(problem, "operator_host", None) is not None:
            if (
                resumed_same_case
                and problem.timings.get("operator_cache") == "hit"
            ):
                log("info: assembled-operator cache is current; not rewriting")
            else:
                from .persist import save_operator

                with stage("save-operator"):
                    save_operator(case_path + ".op.npz", problem)
                log(f"info: cached assembled operator to {case_path}.op.npz")
        log(
            f"info: finished conjugate gradient in {result.iterations} "
            f"iterations (residual {result.residual_norm:.3e})"
        )
        log(f"info: solved system in {result.timings['solve_s']:.3f} seconds")
        if args.von_mises:
            result.stress = result.von_mises
        nodes_path = os.path.join(args.out_dir, "nodes.csv")
        elements_path = os.path.join(args.out_dir, "elements.csv")
        with stage("output"):
            write_results(mesh, result, nodes_path, elements_path, log=log)
        if not args.skip or args.save_plot:
            from .post.plot import plot_results

            with stage("plot"):
                plot_results(
                    mesh,
                    result,
                    cmap=args.cmap,
                    show=not args.skip,
                    save_path=args.save_plot,
                )
    finally:
        if profile_ctx is not None:
            profile_ctx.__exit__(None, None, None)


def main(argv=None) -> int:
    from .errors import MagnetiteError

    try:
        entry(argv)
    except MagnetiteError as err:
        print(f"Received error: {err}", file=sys.stderr)
        return 1
    return 0


if __name__ == "__main__":
    sys.exit(main())
