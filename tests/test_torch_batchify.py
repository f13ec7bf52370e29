"""``voge_tpu_torch.parallel`` (``batchify``, ``Batchifier``) against
``voge_tpu.parallel`` on the cases of ``tests/test_parallel.py:20-60``.  The
second of those holds ``voge_tpu`` to the absent upstream checkout's
``Batchifier``; here the port is held to ``voge_tpu``'s.  Outputs equal
(rtol 1e-6) with the same shapes, with and without padding the last chunk."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from voge_tpu.parallel import Batchifier as JBatchifier
from voge_tpu.parallel import batchify as jbatchify
from voge_tpu_torch.parallel import Batchifier, batchify

torch.set_num_threads(2)


def _xy(seed=0, shape=(6, 5, 2, 2)):
    rs = np.random.RandomState(seed)
    return rs.uniform(size=shape).astype(np.float32), rs.uniform(size=shape).astype(np.float32)


@pytest.mark.parametrize("pad", [True, False])
@pytest.mark.parametrize("bs", [7, 5, 30, 1])
def test_batchify_matches_voge_tpu(pad, bs):
    def foo_t(x, y):
        return x * 2 + y.sum(), y[..., :1]

    def foo_j(x, y):
        return x * 2 + y.sum(), y[..., :1]

    x, y = _xy()
    got = batchify(foo_t, bs, batch_args=("x", "y"), remain_dims=(0, 3),
                   pad_to_full_chunks=pad)(x=torch.tensor(x), y=torch.tensor(y))
    want = jbatchify(foo_j, bs, batch_args=("x", "y"), remain_dims=(0, 3),
                     pad_to_full_chunks=pad)(x=jnp.asarray(x), y=jnp.asarray(y))
    np.testing.assert_allclose(got[1].numpy(), y[..., :1], rtol=1e-6)
    assert got[0].shape == x.shape
    for a, b in zip(got, want):
        assert tuple(a.shape) == tuple(b.shape)
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)


def test_batchifier_matches_voge_tpu():
    x, y = _xy(1)
    out_t = Batchifier(6, batch_args=("x", "y"), remain_dims=(0, 3))(
        lambda x, y: (x + 1, y - 1))(x=torch.tensor(x), y=torch.tensor(y))
    out_j = JBatchifier(6, batch_args=("x", "y"), remain_dims=(0, 3))(
        lambda x, y: (x + 1, y - 1))(x=jnp.asarray(x), y=jnp.asarray(y))
    for a, b in zip(out_t, out_j):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6)
        assert tuple(a.shape) == tuple(b.shape)


@pytest.mark.parametrize("pad", [True, False])
def test_target_dims_scalars_and_padding(pad):
    """``target_dims``, a scalar and a 0-d output (summed over the chunks),
    and the padded last chunk's edge repeat: the function sees full chunks
    only with ``pad_to_full_chunks``."""
    x = np.arange(2 * 9 * 3, dtype=np.float32).reshape(2, 9, 3)
    seen = []

    def f_t(x):
        seen.append(tuple(x.shape))
        return x * 3, 1, x.sum()

    def f_j(x):
        return x * 3, 1, x.sum()

    got = batchify(f_t, 4, "x", target_dims=1, pad_to_full_chunks=pad)(x=torch.tensor(x))
    want = batchify_j = jbatchify(f_j, 4, "x", target_dims=1, pad_to_full_chunks=pad)(
        x=jnp.asarray(x))
    assert seen == [(2, 4, 3)] * 3 if pad else seen == [(2, 4, 3), (2, 4, 3), (2, 1, 3)]
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want[0]), rtol=1e-6)
    assert got[1] == want[1] == 3
    np.testing.assert_allclose(got[2].item(), float(batchify_j[2]), rtol=1e-6)


def test_batchify_refuses_what_voge_tpu_asserts():
    x = torch.zeros((2, 3, 4))
    with pytest.raises(ValueError, match="contiguous"):
        batchify(lambda x: x, 2, "x", target_dims=(0, 2))(x=x)
    with pytest.raises(ValueError, match="leading shape"):
        batchify(lambda x, y: x, 2, ("x", "y"), target_dims=1)(x=x, y=torch.zeros((2, 5, 4)))
