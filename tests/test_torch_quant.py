"""``sema_tpu_torch.ops.quant`` against ``sema_tpu.ops.quant`` on the same
numpy inputs: the row and query quantization and the full-precision
rescore are bit-equal."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.ops import quant as jax_quant
from sema_tpu_torch.ops import quant


def _rows(n=300, d=96, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.standard_normal((n, d)).astype(np.float32)
    x[3] = 0.0                                   # scale 0: the guard
    # exact halves of a quantum: round half to even decides them
    x[4, :6] = [127.0, 0.5, 1.5, 2.5, -0.5, -1.5]
    x[4, 6:] = 0.0
    x[5] *= 1e-30                                # tiny, not zero
    return x


def test_quantize_rows_equals_the_jax_package():
    x = _rows()
    got_q, got_s = quant.quantize_rows(x)
    want_q, want_s = jax_quant.quantize_rows(x)
    np.testing.assert_array_equal(got_q, want_q)
    np.testing.assert_array_equal(got_s, want_s)
    assert got_q.dtype == np.int8 and got_s.dtype == np.float32


@pytest.mark.parametrize("seed", [0, 1])
def test_quantize_query_bit_equal_to_jax(seed):
    x = _rows(seed=seed)
    got_q, got_s = quant.quantize_query(torch.from_numpy(x))
    want_q, want_s = jax_quant.quantize_query(jnp.asarray(x))
    np.testing.assert_array_equal(got_q.numpy(), np.asarray(want_q))
    np.testing.assert_array_equal(got_s.numpy(), np.asarray(want_s))
    assert got_q.dtype == torch.int8 and got_s.dtype == torch.float32
    assert got_q[4, :6].tolist() == [127, 0, 2, 2, 0, -2]   # half to even
    assert got_s[3] == 0 and not got_q[3].any()


def test_device_row_quantization_equals_the_host_oracle():
    """The store quantizes its bf16 rows on the device with
    quantize_query; the numpy quantize_rows of the same rows agrees."""
    x = torch.from_numpy(_rows()).bfloat16()
    got_q, got_s = quant.quantize_rows_device(x)
    want_q, want_s = jax_quant.quantize_rows(x.float().numpy())
    np.testing.assert_array_equal(got_q.numpy(), want_q)
    np.testing.assert_array_equal(got_s.numpy(), want_s)


def test_rescore_exact_equals_the_jax_package():
    rng = np.random.default_rng(3)
    full = rng.standard_normal((40, 64)).astype(np.float32)
    full[[5, 9]] = full[2]                       # ties keep input order
    query = rng.standard_normal(64).astype(np.float32)
    ids = rng.permutation(1000)[:40].astype(np.int64)
    got = quant.rescore_exact(full, query, ids, 10)
    want = jax_quant.rescore_exact(full, query, ids, 10)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
