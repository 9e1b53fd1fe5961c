"""4096-variant design sweep in one batched solve.

Vary the prescribed pull displacement and the Young's-modulus scale across
4096 variants of a tensile plate; all variants solve concurrently as
lanes of one batched field, preconditioned by ONE shared multigrid
hierarchy. Run:

    python examples/design_sweep.py [n_variants]
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

import time

import numpy as np

from magnetite_tpu.config import ModelMetadata
from magnetite_tpu.meshing.generators import rect_mesh, tensile_bcs_for_rect


def main():
    import jax

    from magnetite_tpu.utils.jaxcache import enable_persistent_cache

    enable_persistent_cache()
    b = int(sys.argv[1]) if len(sys.argv) > 1 else 4096
    mesh = rect_mesh(64, 32, width=2.0)
    base = tensile_bcs_for_rect(mesh.coords, pull=0.01)
    metadata = ModelMetadata(
        youngs_modulus=69e9, poisson_ratio=0.33, part_thickness=0.5,
        characteristic_length_min=0.0, characteristic_length_max=0.05,
    )

    rng = np.random.default_rng(0)
    pulls = rng.uniform(0.005, 0.02, b).astype(np.float32)
    k_scales = rng.uniform(0.5, 2.0, b)  # Young's modulus scale per variant
    right = np.isclose(mesh.coords[:, 0], 2.0)
    u_values = np.tile(base.u_value[None], (b, 1, 1)).astype(np.float32)
    u_values[:, right, 0] = pulls[:, None]
    f_values = np.zeros((b, mesh.num_nodes, 2), dtype=np.float32)

    # serving pattern: compile once (assembly + multigrid hierarchy stay
    # device-resident), then time warm batches
    from magnetite_tpu.parallel.sweep import compile_sweep

    compiled = compile_sweep(mesh, base, metadata, iterations=20)
    result = compiled.solve(u_values, f_values, k_scales)  # warm-up
    float(np.asarray(result.residual_norm)[0])
    t0 = time.perf_counter()
    result = compiled.solve(u_values, f_values, k_scales)
    rel = np.asarray(result.residual_norm) / np.asarray(result.rhs_norm)
    t = time.perf_counter() - t0

    print(f"{b} variants in {t:.3f}s -> {b / t:.0f} solves/s")
    print(f"worst relative residual: {rel.max():.2e}")
    vm_max = np.asarray(result.von_mises).max(axis=1)  # [B]
    worst = int(np.argmax(vm_max))
    print(f"highest-stress variant: pull={pulls[worst]:.4f}, "
          f"k_scale={k_scales[worst]:.2f}, "
          f"max von Mises={vm_max[worst]:.3e}")

    # --- TRUE material sweep: per-lane (E, nu, t) ----------------------
    # Three basis stencils span every material (the D matrix is linear in
    # its coefficients) and the multigrid hierarchy coarsens each basis,
    # so every lane is preconditioned by its EXACT coarse operators.
    from magnetite_tpu.parallel.sweep import compile_material_sweep

    compiled = compile_material_sweep(mesh, base, iterations=20)
    e_moduli = rng.uniform(40e9, 250e9, b).astype(np.float32)
    nus = rng.uniform(0.22, 0.38, b).astype(np.float32)
    thicknesses = rng.uniform(0.2, 1.0, b).astype(np.float32)
    mres = compiled.solve(u_values, f_values, e_moduli, nus, thicknesses)
    float(np.asarray(mres.residual_norm)[0])  # warm-up sync
    t0 = time.perf_counter()
    mres = compiled.solve(u_values, f_values, e_moduli, nus, thicknesses)
    mrel = np.asarray(mres.residual_norm) / np.asarray(mres.rhs_norm)
    t = time.perf_counter() - t0
    print(f"material sweep: {b} (E, nu, t) variants in {t:.3f}s "
          f"-> {b / t:.0f} solves/s, worst rel residual {mrel.max():.2e}")


if __name__ == "__main__":
    main()
