"""Test harness configuration.

Tests run on CPU with 8 virtual devices (sharding tests exercise the same
shard_map code that runs over real multi-GPU meshes) and f64 enabled
(the accuracy bar is 1e-6+ relative vs the dense oracle).

Environment must be set before jax is imported anywhere.
"""

import os

os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import jax  # noqa: E402

from magnetite_tpu.utils.jaxcache import enable_persistent_cache  # noqa: E402

jax.config.update("jax_enable_x64", True)
# Persistent compilation cache: jit compiles dominate test wall time otherwise.
enable_persistent_cache(min_compile_secs=0.0)
jax.config.update("jax_persistent_cache_min_entry_size_bytes", 0)

import numpy as np  # noqa: E402
import pytest  # noqa: E402

from magnetite_tpu.config import (  # noqa: E402
    BoundaryRegion,
    BoundaryRule,
    BoundaryTarget,
    ModelMetadata,
)
from magnetite_tpu.meshing.core import Mesh  # noqa: E402


@pytest.fixture
def metadata():
    return ModelMetadata(
        youngs_modulus=69e9,
        poisson_ratio=0.33,
        part_thickness=0.5,
        characteristic_length_min=0.0,
        characteristic_length_max=0.3,
    )


@pytest.fixture
def unit_triangle_mesh():
    """One CCW right triangle with legs of length 1."""
    coords = np.array([[0.0, 0.0], [1.0, 0.0], [0.0, 1.0]])
    tris = np.array([[0, 1, 2]], dtype=np.int32)
    return Mesh(coords=coords, tris=tris)


@pytest.fixture
def two_triangle_mesh():
    """Unit square split into two CCW triangles."""
    coords = np.array([[0.0, 0.0], [1.0, 0.0], [1.0, 1.0], [0.0, 1.0]])
    tris = np.array([[0, 1, 2], [0, 2, 3]], dtype=np.int32)
    return Mesh(coords=coords, tris=tris)


def make_rule(name="r", region=None, **targets):
    return BoundaryRule(
        name=name,
        region=region or BoundaryRegion(),
        target=BoundaryTarget(**targets),
    )
