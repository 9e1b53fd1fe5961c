"""magnetite_tpu — a JAX 2D plane-stress FEA framework.

A from-scratch rebuild of the capabilities of kyle-tennison/Magnetite
(a Rust CLI: SVG/CSV geometry -> Gmsh triangle mesh -> CST stiffness ->
CG solve -> stress recovery -> matplotlib plot), redesigned for an
accelerator:

  * host front-end: SVG/CSV parsing, meshing (built-in Delaunay backend or
    Gmsh subprocess), boundary-condition rules -> flat device arrays
  * device core (JAX/XLA): closed-form fused element assembly into
    banded/stencil/ELL operators, geometric-multigrid and
    smoothed-aggregation-AMG preconditioned CG (mesh-independent iteration
    counts on any triangle mesh), mixed-precision f64/f32 solves, lane-
    batched load and material design sweeps, shard_map multi-chip solves
    (halo-exchange stencil and banded paths) over a jax.sharding.Mesh
"""

from .utils.hostmem import tune_glibc_malloc as _tune_glibc_malloc

# Large numpy temporaries (meshing, assembly, AMG setup) otherwise pay a
# kernel mmap/fault/munmap round trip per allocation; see utils/hostmem.py.
_tune_glibc_malloc()

from .config import (
    BoundaryRegion,
    BoundaryRule,
    BoundaryTarget,
    ModelMetadata,
    SimulationInput,
    SolverOptions,
    load_simulation_input,
    parse_simulation_input,
)
from .errors import (
    InputError,
    MagnetiteError,
    MesherError,
    PostProcessorError,
    SolverError,
)
from .bc import BCArrays, apply_boundary_conditions
from .meshing.core import Mesh, normalize_orientation, signed_areas
from .fem.solve import CompiledProblem, SolveResult, compile_problem, solve_system

__version__ = "0.1.0"

__all__ = [
    "BCArrays",
    "BoundaryRegion",
    "BoundaryRule",
    "BoundaryTarget",
    "CompiledProblem",
    "InputError",
    "MagnetiteError",
    "Mesh",
    "MesherError",
    "ModelMetadata",
    "PostProcessorError",
    "SimulationInput",
    "SolveResult",
    "SolverError",
    "SolverOptions",
    "apply_boundary_conditions",
    "compile_problem",
    "load_simulation_input",
    "normalize_orientation",
    "parse_simulation_input",
    "signed_areas",
    "solve_system",
]
