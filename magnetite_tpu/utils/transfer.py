"""Host->device upload of a list of host arrays."""

from __future__ import annotations

import jax
import numpy as np


def packed_device_put(arrays) -> list:
    """Upload host arrays with one pytree `jax.device_put`; returns the
    device arrays in input order."""
    return list(jax.device_put([np.ascontiguousarray(a) for a in arrays]))
