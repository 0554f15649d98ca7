"""The port's embedding bag (``repro_torch.kernels.embedding_bag`` and
``kernels.ops.embedding_bag``) against the JAX reference on the CPU.

Ids and tables come from numpy seeds and go to both packages as the same
values.  The plain version and ``ops.embedding_bag(impl="auto")`` on CPU
tensors are held against the reference's Pallas kernel in interpret mode
and its ``ref.embedding_bag_ref`` at the reference test's tolerances:
float32 atol 1e-5, bfloat16 atol 5e-2 (both sum in float32, in another
order, and bfloat16 rounds the output).  A bag of one is exact
(``0 + row``) and held bit for bit."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ref as jref
from repro.kernels.embedding_bag import embedding_bag as jbag
from repro_torch.kernels import embedding_bag as tbk
from repro_torch.kernels import ops as tops

# the reference test sweep (tests/test_kernels.py), the CTR hot-cache
# lookup at a reduced size, and widths off any lane multiple
SWEEP = [
    # N, bag, V, dim
    (8, 4, 100, 128),
    (16, 1, 50, 128),
    (4, 16, 1000, 256),
    (96, 1, 64, 16),
    (7, 3, 50, 5),
]
DTYPES = [(jnp.float32, torch.float32, 1e-5),
          (jnp.bfloat16, torch.bfloat16, 5e-2)]


def _inputs(N, bag, V, dim, seed=0):
    r = np.random.default_rng(seed)
    return (r.integers(0, V, (N, bag)).astype(np.int32),
            r.standard_normal((V, dim)).astype(np.float32))


def _both(ids, table, jdt, tdt):
    return ((jnp.asarray(ids), jnp.asarray(table, jdt)),
            (torch.from_numpy(ids), torch.from_numpy(table).to(tdt)))


def _f32(x):
    return np.asarray(torch.as_tensor(x).float() if isinstance(
        x, torch.Tensor) else np.asarray(x, np.float32))


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
@pytest.mark.parametrize("N,bag,V,dim", SWEEP)
def test_plain_matches_reference_kernel_and_oracle(N, bag, V, dim, jdt, tdt,
                                                   tol):
    (ji, jt), (ti, tt) = _both(*_inputs(N, bag, V, dim), jdt, tdt)
    want_kernel = _f32(jbag(ji, jt, interpret=True))
    want_ref = _f32(jref.embedding_bag_ref(ji, jt))
    for got in (tbk.embedding_bag_ref(ti, tt), tops.embedding_bag(ti, tt)):
        assert got.dtype == tdt and got.shape == (N, dim)
        np.testing.assert_allclose(_f32(got), want_kernel, atol=tol, rtol=0)
        np.testing.assert_allclose(_f32(got), want_ref, atol=tol, rtol=0)


def test_duplicate_ids():
    ids = np.zeros((4, 8), np.int32)        # all the same row
    _, table = _inputs(1, 1, 10, 128)
    (ji, jt), (ti, tt) = _both(ids, table, jnp.float32, torch.float32)
    got = _f32(tops.embedding_bag(ti, tt))
    np.testing.assert_allclose(got, np.repeat(8 * table[:1], 4, 0), rtol=1e-5)
    np.testing.assert_allclose(got, _f32(jbag(ji, jt, interpret=True)),
                               atol=1e-5, rtol=0)


@pytest.mark.parametrize("jdt,tdt,tol", DTYPES)
def test_out_of_range_ids_clamp_as_the_clamping_gather(jdt, tdt, tol):
    ids, table = _inputs(12, 5, 30, 16, seed=3)
    ids[::2, 0] = -4
    ids[1::3, 3] = 30 + 11
    ids[5, 2] = 2 ** 31 - 1
    (ji, jt), (ti, tt) = _both(ids, table, jdt, tdt)
    clamped = jnp.take(jt, ji, axis=0, mode="clip").astype(jnp.float32)
    want = _f32(clamped.sum(axis=1).astype(jdt))
    # (the Pallas kernel defines no out-of-range behaviour: its interpret
    # mode does not clamp, so only the clamping gather is the reference)
    for i in (ti, ti.long()):
        np.testing.assert_allclose(_f32(tops.embedding_bag(i, tt)), want,
                                   atol=tol, rtol=0)


@pytest.mark.parametrize("tdt", [torch.float32, torch.bfloat16])
def test_bag_of_one_is_bit_equal_to_a_gather(tdt):
    ids, table = _inputs(200, 1, 64, 16, seed=5)
    tt = torch.from_numpy(table).to(tdt)
    got = tops.embedding_bag(torch.from_numpy(ids), tt)
    assert torch.equal(got, tt[torch.from_numpy(ids[:, 0]).long()])


def test_impl_choices():
    ids, table = (torch.from_numpy(a) for a in _inputs(4, 2, 10, 8))
    with pytest.raises(ValueError, match="needs CUDA tensors"):
        tops.embedding_bag(ids, table, impl="cuda")
    with pytest.raises(ValueError, match="auto/ref/cuda"):
        tops.embedding_bag(ids, table, impl="interpret")
    assert torch.equal(tops.embedding_bag(ids, table, impl="ref"),
                       tops.embedding_bag(ids, table))


def test_launcher_refuses_autograd_and_cpu_tensors():
    ids, table = (torch.from_numpy(a) for a in _inputs(4, 2, 10, 8))
    with pytest.raises(RuntimeError, match="no backward"):
        tbk.embedding_bag_cuda(ids, table.clone().requires_grad_(True))
    with pytest.raises(ValueError, match="CUDA tensors only"):
        tbk.embedding_bag_cuda(ids, table)
    assert tbk.embedding_bag_cuda.launches == 0


def test_plain_version_stays_differentiable():
    ids = torch.tensor([[0, 2, 2], [1, 1, 3]])
    table = torch.randn((4, 5), requires_grad=True)
    tbk.embedding_bag_ref(ids, table).sum().backward()
    assert table.grad[:, 0].tolist() == [1.0, 2.0, 2.0, 1.0]
