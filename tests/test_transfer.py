"""Host->device upload helper (utils/transfer.py)."""

import numpy as np
import pytest

from magnetite_tpu.utils.transfer import packed_device_put


@pytest.mark.parametrize("seed,n_arrays", [(2, 5), (3, 30)])
def test_packed_device_put_preserves_order(seed, n_arrays):
    rng = np.random.default_rng(seed)
    arrays = [
        rng.random(int(rng.integers(10, 200_000))) for _ in range(n_arrays)
    ]
    arrays.insert(2, rng.random(9_000_000))  # one large array among smalls
    outs = packed_device_put(arrays)
    assert len(outs) == len(arrays)
    for a, d in zip(arrays, outs):
        np.testing.assert_array_equal(np.asarray(d), a)


def test_packed_device_put_mixed_dtypes_and_shapes():
    rng = np.random.default_rng(4)
    arrays = [
        rng.random((100, 3)).astype(np.float32),
        rng.integers(0, 100, size=(50,)).astype(np.int32),
        rng.random((7, 2, 3)),
        np.zeros((1,), dtype=np.float64),
    ]
    outs = packed_device_put(arrays)
    for a, d in zip(arrays, outs):
        out = np.asarray(d)
        assert out.dtype == a.dtype and out.shape == a.shape
        np.testing.assert_array_equal(out, a)
