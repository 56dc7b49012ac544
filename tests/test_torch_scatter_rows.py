"""The row scatter-add of the port (``pagnerf_tpu_torch/ops/scatter_rows.py``)
against the JAX package's ``scatter_rows_matmul`` and a numpy float64 sum,
on the CPU.

- ``scatter_rows_plain`` against ``scatter_rows_matmul(..., interpret=True)``:
  per entry |diff| <= 2^-8 * sum|vals| + 1e-6, because the TPU kernel rounds
  ``vals`` to bfloat16 (relative error up to 2^-9 per value) before its
  float32 sum, and the plain version sums the float32 values in float64.
- Against numpy (float64 sum of the in-range rows, rounded once to
  float32): equal. The float32 values here sum exactly in float64, so both
  sums are the same float64 number whatever their order.
- The wrapper takes the plain version for CPU tensors, counts no launch, and
  refuses what the kernel does not take.
"""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pagnerf_tpu.ops.pallas_scatter import scatter_rows_matmul
from pagnerf_tpu_torch.ops import scatter_rows as sr


def _numpy_sum(row, vals, num_rows):
    out = np.zeros((num_rows, vals.shape[1]), np.float64)
    keep = (row >= 0) & (row < num_rows)
    np.add.at(out, row[keep], vals[keep].astype(np.float64))
    return out.astype(np.float32)


def _inputs(seed, m, num_rows, low=0, high=None):
    rng = np.random.default_rng(seed)
    row = rng.integers(low, num_rows if high is None else high, m).astype(np.int32)
    vals = rng.standard_normal((m, sr.WIDTH)).astype(np.float32)
    return row, vals


@pytest.mark.parametrize("m,num_rows,kwargs", [
    (3000, 512, dict(row_block=128, event_chunk=512)),   # grid path, duplicates
    (700, 640, {}),                                      # resident path, 640 rows
    (1500, 256, dict(event_chunk=512)),                  # -1 and >= num_rows padding
])
def test_plain_matches_pallas_interpret(m, num_rows, kwargs):
    padded = num_rows == 256
    row, vals = _inputs(m + num_rows, m, num_rows,
                        low=-1 if padded else 0, high=num_rows + 9 if padded else None)
    ref = scatter_rows_matmul(jnp.asarray(row), jnp.asarray(vals), num_rows,
                              interpret=True, **kwargs)
    got = sr.scatter_rows_plain(torch.from_numpy(row), torch.from_numpy(vals), num_rows)
    mag = _numpy_sum(row, np.abs(vals), num_rows)
    assert got.shape == (num_rows, sr.WIDTH) and got.dtype == torch.float32
    assert np.all(np.abs(got.numpy() - np.asarray(ref)) <= 2.0 ** -8 * mag + 1e-6)


@pytest.mark.parametrize("case", ["duplicates", "padding", "num_rows_640", "one_row"])
def test_plain_equals_numpy_float64_sum(case):
    if case == "duplicates":
        row, vals = _inputs(1, 5000, 37)                 # ~135 events per row
        num_rows = 37
    elif case == "padding":
        row, vals = _inputs(2, 2000, 100, low=-1, high=130)
        num_rows = 100
        assert (row == -1).any() and (row >= num_rows).any()
    elif case == "num_rows_640":
        row, vals = _inputs(3, 3000, 640)
        row[:3] = [0, 639, 639]
        num_rows = 640
    else:
        row, vals = _inputs(4, 300, 1)
        num_rows = 1
    got = sr.scatter_rows_plain(torch.from_numpy(row), torch.from_numpy(vals), num_rows)
    np.testing.assert_array_equal(got.numpy(), _numpy_sum(row, vals, num_rows))


def test_zero_events_give_zeros():
    got = sr.scatter_rows(torch.zeros((0,), dtype=torch.int32),
                          torch.zeros((0, sr.WIDTH)), 64)
    assert got.shape == (64, sr.WIDTH)
    assert bool((got == 0).all())


def test_cpu_wrapper_takes_plain_and_counts_nothing():
    row, vals = _inputs(5, 500, 48)
    before = sr.scatter_rows.launches
    got = sr.scatter_rows(torch.from_numpy(row), torch.from_numpy(vals), 48)
    assert sr.scatter_rows.launches == before
    np.testing.assert_array_equal(got.numpy(), _numpy_sum(row, vals, 48))


@pytest.mark.parametrize("case", ["row_dtype", "vals_dtype", "vals_width", "row_dims",
                                  "lengths", "contiguous", "num_rows", "num_rows_type"])
def test_wrapper_rejects_what_the_kernel_does_not_take(case):
    row, vals = (torch.from_numpy(a) for a in _inputs(6, 64, 16))
    num_rows = 16
    if case == "row_dtype":
        row = row.long()
    elif case == "vals_dtype":
        vals = vals.bfloat16()
    elif case == "vals_width":
        vals = vals[:, :64].contiguous()
    elif case == "row_dims":
        row = row.reshape(8, 8)
    elif case == "lengths":
        row = row[1:]
    elif case == "contiguous":
        vals = torch.cat([vals, vals], dim=1)[:, ::2]
    elif case == "num_rows":
        num_rows = 0
    else:
        num_rows = 16.0
    with pytest.raises((TypeError, ValueError)):
        sr.scatter_rows(row, vals, num_rows)
