"""The port's pairwise_cheb against ``repro.kernels.pairwise_cheb``.

Same inputs (numpy, seeded) through both packages, a batch of samples
at once on the port's side and one sample at a time on the reference's.
The port's plain version (``ref.py``) is held bit-equal (tolerance 0,
NaN positions equal) to JAX's ``pairwise_cheb_ref`` and to the Pallas
kernel run in interpret mode, at the shapes of
``tests/test_kernels.py::TestPairwiseChebKernel`` plus ragged masks,
exact-zero plateaus and non-finite inputs.  The ``cuda``-marked test
holds the CUDA kernel bit-equal to the plain version on the card.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.pairwise_cheb.ops import pairwise_cheb as j_pairwise_cheb
from repro.kernels.pairwise_cheb.ref import pairwise_cheb_ref
from repro_torch.kernels.pairwise_cheb import kernel, ops, ref

B = 3
SHAPES = [(64, 64), (256, 128), (300, 128), (1024, 256)]


def _samples(P, seed, nonfinite=False):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, P)).astype(np.float32)
    y = rng.normal(size=(B, P)).astype(np.float32)
    x[:, : P // 4] = np.round(x[:, : P // 4])  # repeated values
    mask = rng.uniform(size=(B, P)) > 0.2
    mask[-1, P // 2:] = False  # a ragged tail
    if nonfinite:
        x[0, 3], y[1, 5], x[2, 7] = np.nan, np.inf, -np.inf
        y[2, 9] = np.nan
        mask[:, :10] = True
    return x, y, mask


def assert_bit_equal(got, want):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape
    np.testing.assert_array_equal(np.isnan(got), np.isnan(want))
    ok = ~np.isnan(want)
    np.testing.assert_array_equal(got[ok], want[ok])


def _port(x, y, mask):
    return ref.pairwise_cheb(torch.from_numpy(x), torch.from_numpy(y),
                             torch.from_numpy(mask))


@pytest.mark.parametrize("P,block", SHAPES)
def test_ref_equals_jax_ref_and_interpret_kernel(P, block):
    x, y, mask = _samples(P, seed=P)
    got = _port(x, y, mask)
    for b in range(B):
        args = (jnp.asarray(x[b]), jnp.asarray(y[b]), jnp.asarray(mask[b]))
        want_ref = pairwise_cheb_ref(*args)
        want_kernel = j_pairwise_cheb(*args, use_kernel=True, block=block)
        for g, wr, wk in zip(got, want_ref, want_kernel):
            assert g.dtype == torch.float32
            assert_bit_equal(g[b].numpy(), wr)
            assert_bit_equal(g[b].numpy(), wk)


def test_nonfinite_inputs_propagate_nan_like_jax():
    """inf - inf and NaN inputs give NaN where JAX gives NaN; DJ's max
    propagates a NaN from either marginal (jnp.maximum semantics)."""
    x, y, mask = _samples(64, seed=5, nonfinite=True)
    got = _port(x, y, mask)
    assert torch.isnan(got[2][0, 3]).any()  # NaN x reaches DJ
    for b in range(B):
        want = pairwise_cheb_ref(jnp.asarray(x[b]), jnp.asarray(y[b]),
                                 jnp.asarray(mask[b]))
        for g, w in zip(got, want):
            assert_bit_equal(g[b].numpy(), w)


def test_repeated_values_exact_zero():
    """Mixture distributions need exact-zero plateaus preserved."""
    x = torch.from_numpy(np.repeat([1.5, 2.5], 64).astype(np.float32))
    _, _, dj = ops.pairwise_cheb(x[None].repeat(2, 1), x[None].repeat(2, 1),
                                 torch.ones(2, 128, dtype=torch.bool))
    same = np.repeat([0, 1], 64)
    block_same = same[:, None] == same[None, :]
    off_diag = ~np.eye(128, dtype=bool)
    for b in range(2):
        d = dj[b].numpy()
        assert np.all(d[block_same & off_diag] == 0.0)
        assert np.all(np.isinf(d[np.eye(128, dtype=bool)]))


def test_ops_batch_shape_and_fencing():
    x, y, mask = _samples(40, seed=9)
    T = torch.from_numpy
    dx, dy, dj = ops.pairwise_cheb(T(x).reshape(1, B, 40), T(y).reshape(1, B, 40),
                                   T(mask).reshape(1, B, 40))
    assert dx.shape == dy.shape == dj.shape == (1, B, 40, 40)
    invalid = ~(mask[:, :, None] & mask[:, None, :])
    for d in (dx, dy, dj):
        assert np.all(np.isinf(d[0].numpy()[invalid]))
    diag = np.eye(40, dtype=bool)
    assert np.all(np.isinf(dj[0].numpy()[:, diag]))
    assert np.all(dx[0].numpy()[:, diag][mask] == 0.0)  # only DJ's diagonal is fenced


def test_kernel_refuses_cpu_tensors():
    x = torch.zeros(2, 8)
    with pytest.raises(ValueError, match="CUDA"):
        kernel.pairwise_cheb(x, x, x > 0)


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("P,nonfinite", [(64, False), (256, False), (300, False),
                                         (512, False), (64, True)])
def test_cuda_kernel_matches_plain(cuda_device, P, nonfinite):
    """On the card: the CUDA kernel bit-equal to the plain version."""
    x, y, mask = _samples(P, seed=P + 1, nonfinite=nonfinite)
    T = [torch.from_numpy(a).to(cuda_device) for a in (x, y, mask)]
    before = kernel.pairwise_cheb.launches
    got = kernel.pairwise_cheb(*T)
    want = ref.pairwise_cheb(*T)
    torch.cuda.synchronize()
    assert kernel.pairwise_cheb.launches == before + 1
    for g, w in zip(got, want):
        assert_bit_equal(g.cpu(), w.cpu())
    # and through ops, which dispatches CUDA tensors to the kernel
    ops.pairwise_cheb(*T)
    assert kernel.pairwise_cheb.launches == before + 2
