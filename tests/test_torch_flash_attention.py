"""The port's flash attention against ``repro.kernels.flash_attention``.

The same inputs (seeded numpy) go through both packages.  The port's
plain versions (``ref.mha_reference``, ``ref.chunked_attention``) are
held against JAX's ``mha_reference``, ``chunked_attention`` and the
Pallas kernel run in interpret mode (``ops.attention(use_kernel=True)``):
causal and not, GQA groups 1/2/4, ragged S, Dk != Dv, bfloat16.

Tolerances.  float32: atol 2e-5, the bound ``tests/test_kernels.py``
puts on the Pallas kernel against its naive oracle; both sides compute
the same sums in float32 and differ only in summation order.  bfloat16:
both sides accumulate in float32 and round once at the end, so an output
may differ by one bfloat16 ulp (a relative spacing of at most 2^-7).

The ``cuda``-marked tests hold the CUDA-core kernel against the plain
versions on the card (the same tolerances; 16-bit outputs of the basic
body also within one spacing + 2e-5) and skip without one: both of its
bodies, the register-tiled one also against the basic one on the same
inputs (atol 2e-5), the basic body on every input the register-tiled one
refuses (head dims above 128, 16-bit at other head dims, S = 1 and under
one key tile, unaligned views, a group of 256 heads, MLA's operands), and
the rule ``kernel.takes_regtile`` that picks between them; the CPU
replays of the two routes are ``tests/test_torch_flash_f32_design.py``
and ``tests/test_torch_flash_basic_design.py``.  The Hopper kernel and the
p_dtype plain version are held in ``tests/test_torch_flash_wgmma.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import attention as j_attention
from repro.kernels.flash_attention.ref import chunked_attention as j_chunked
from repro.kernels.flash_attention.ref import mha_reference as j_mha
from repro_torch.kernels.flash_attention import kernel, ops, ref
from _torch_threads import one_thread  # noqa: F401 (autouse)

F32_ATOL = 2e-5
BF16_RTOL = 2.0 ** -7


def _inputs(b, hq, hkv, s, dk, dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, dk)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, dk)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, dv)).astype(np.float32)
    return q, k, v


def _torch(arrays, dtype=torch.float32, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def _jax(arrays, dtype=jnp.float32):
    return [jnp.asarray(a, dtype) for a in arrays]


def _np(t):
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu().numpy()
    return np.asarray(t, np.float32)


def assert_bf16_close(got, want):
    """Within one bfloat16 ulp: |got - want| <= 2^-7 * |want| (+ a floor
    for outputs near zero)."""
    got, want = _np(got), _np(want)
    np.testing.assert_allclose(got, want, rtol=BF16_RTOL, atol=1e-6)


# (b, hq, hkv, s, dk, dv): groups 1/2/4, ragged S, Dk != Dv (MLA's 192/128
# scaled down), head dims of the smoke configs.
CASES = [
    (1, 2, 2, 64, 16, 16),     # MHA, group 1
    (2, 4, 2, 100, 32, 32),    # group 2, ragged S
    (1, 8, 2, 129, 24, 16),    # group 4, ragged S, Dk != Dv
    (1, 4, 1, 1, 16, 16),      # a single position
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_mha_reference_equals_jax(case, causal):
    b, hq, hkv, s, dk, dv = case
    arrs = _inputs(*case, seed=s + hq)
    scale = 1.0 / dk ** 0.5
    got = ref.mha_reference(*_torch(arrs), scale=scale, causal=causal)
    want = j_mha(*_jax(arrs), scale=scale, causal=causal)
    assert got.shape == (b, hq, s, dv) and got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case,chunk", [
    ((2, 4, 2, 128, 32, 32), 32),
    ((1, 8, 2, 96, 24, 16), 48),
    ((1, 2, 2, 64, 16, 16), 64),
])
def test_chunked_equals_jax_chunked(case, chunk, causal, monkeypatch):
    """JAX's chunked path needs S % chunk == 0; at those shapes both
    packages run the same online softmax (the port's chunk forced)."""
    monkeypatch.setattr(ref, "_CHUNK", chunk)
    arrs = _inputs(*case, seed=chunk)
    scale = 1.0 / case[4] ** 0.5
    got = ref.chunked_attention(*_torch(arrs), scale=scale, causal=causal)
    want = j_chunked(*_jax(arrs), scale=scale, causal=causal, chunk=chunk)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("chunk", [7, 64, 1024])
def test_chunked_any_s_equals_jax_mha(case, chunk, causal, monkeypatch):
    """The port's chunked version takes any S (a shorter last chunk)."""
    monkeypatch.setattr(ref, "_CHUNK", chunk)
    arrs = _inputs(*case, seed=chunk + case[3])
    scale = 1.0 / case[4] ** 0.5
    got = ref.chunked_attention(*_torch(arrs), scale=scale, causal=causal)
    want = j_mha(*_jax(arrs), scale=scale, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)


@pytest.mark.parametrize("case", [
    (1, 2, 2, 128, 64, 64),    # group 1, one 128 block
    (1, 4, 2, 200, 32, 32),    # group 2, ragged S padded by the reference
    (1, 8, 2, 128, 24, 16),    # group 4, Dk != Dv, head dims padded
])
def test_port_equals_interpret_kernel_causal(case):
    """The Pallas kernel in interpret mode (the reference pads S and D
    and slices back) against the port's CPU path, causal."""
    arrs = _inputs(*case, seed=7)
    scale = 1.0 / case[4] ** 0.5
    got = ops.attention(*_torch(arrs), scale=scale, causal=True)
    want = j_attention(*_jax(arrs), scale=scale, causal=True, use_kernel=True,
                       block_q=128, block_k=128)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)


def test_port_equals_interpret_kernel_non_causal_block_multiple():
    arrs = _inputs(1, 4, 2, 256, 32, 32, seed=8)
    got = ops.attention(*_torch(arrs), causal=False)
    want = j_attention(*_jax(arrs), causal=False, use_kernel=True,
                       block_q=128, block_k=128)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)


def test_non_causal_ragged_s_follows_mha_reference():
    """At S=200 with 128 blocks the reference's ``ops.attention(causal=
    False)`` lets its 56 zero-padded keys into the softmax and departs
    from its own ``mha_reference``; the port computes the unpadded
    function and is held against ``mha_reference``."""
    arrs = _inputs(1, 2, 2, 200, 64, 64, seed=9)
    scale = 1.0 / 8.0
    got = ops.attention(*_torch(arrs), scale=scale, causal=False)
    want = j_mha(*_jax(arrs), scale=scale, causal=False)
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)
    padded = j_attention(*_jax(arrs), scale=scale, causal=False,
                         use_kernel=True, block_q=128, block_k=128)
    assert np.abs(_np(padded) - _np(want)).max() > 1e-3


@pytest.mark.parametrize("causal", [True, False])
def test_bf16_within_one_ulp_of_jax(causal):
    arrs = _inputs(1, 4, 2, 100, 32, 32, seed=10)
    scale = 1.0 / 32 ** 0.5
    tq = _torch(arrs, torch.bfloat16)
    jq = _jax(arrs, jnp.bfloat16)
    got_mha = ref.mha_reference(*tq, scale=scale, causal=causal)
    got_chunk = ops.attention(*tq, scale=scale, causal=causal)
    want = j_mha(*jq, scale=scale, causal=causal)
    assert got_mha.dtype == got_chunk.dtype == torch.bfloat16
    assert_bf16_close(got_mha, want)
    assert_bf16_close(got_chunk, want)


def test_bf16_equals_interpret_kernel_causal():
    arrs = _inputs(1, 2, 2, 128, 64, 64, seed=11)
    got = ops.attention(*_torch(arrs, torch.bfloat16), causal=True)
    want = j_attention(*_jax(arrs, jnp.bfloat16), causal=True,
                       use_kernel=True, block_q=128, block_k=128)
    assert_bf16_close(got, want)


def test_default_scale_and_strided_views():
    """``scale=None`` is 1/sqrt(Dk); transposed (B, S, H, D) views give
    the same result as contiguous copies."""
    arrs = _inputs(2, 4, 2, 33, 16, 16, seed=12)
    q, k, v = _torch(arrs)
    want = ref.mha_reference(q, k, v, scale=0.25)
    views = [t.transpose(1, 2).contiguous().transpose(1, 2) for t in (q, k, v)]
    assert not views[0].is_contiguous()
    np.testing.assert_allclose(_np(ops.attention(*views)), _np(want),
                               atol=F32_ATOL)


def test_kernel_wrapper_refuses_cpu_tensors():
    q, k, v = _torch(_inputs(1, 2, 2, 8, 16, 16, seed=13))
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention(q, k, v, scale=0.25)


# ---------------------------------------------------------------------------
# On the card: the CUDA kernel against the plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


CUDA_CASES = [
    (1, 2, 2, 1, 16, 16),
    (2, 4, 2, 100, 128, 128),
    (1, 8, 2, 300, 192, 128),
    (1, 4, 1, 257, 16, 16),
    (1, 2, 2, 130, 256, 256),
]


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CUDA_CASES)
def test_cuda_kernel_matches_plain_f32(cuda_device, case, causal):
    arrs = _inputs(*case, seed=case[3])
    q, k, v = _torch(arrs, device=cuda_device)
    scale = 1.0 / case[4] ** 0.5
    before = kernel.flash_attention_simt.launches
    got = ops.attention(q, k, v, scale=scale, causal=causal)
    assert kernel.flash_attention_simt.launches == before + 1
    want = ref.mha_reference(q, k, v, scale=scale, causal=causal)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_cuda_kernel_matches_plain_half(cuda_device, dtype):
    """The CUDA-core kernel on 16-bit inputs (``ops.attention`` sends these
    to the Hopper kernel; tests/test_torch_flash_wgmma.py holds that one)."""
    arrs = _inputs(1, 16, 8, 513, 128, 128, seed=14)
    q, k, v = _torch(arrs, dtype=dtype, device=cuda_device)
    got = kernel.flash_attention_simt(q, k, v, scale=1.0 / 128 ** 0.5,
                                      causal=True)
    want = ref.chunked_attention(q, k, v, scale=1.0 / 128 ** 0.5, causal=True)
    torch.cuda.synchronize()
    assert got.dtype == dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL, atol=1e-6)


@pytest.mark.cuda
def test_cuda_kernel_refuses_unsupported_shapes(cuda_device):
    q, k, v = _torch(_inputs(1, 2, 2, 8, 12, 12, seed=15), device=cuda_device)
    with pytest.raises(ValueError, match="multiples of 8"):
        kernel.flash_attention(q, k, v, scale=0.25)


# (b, hq, hkv, s, dk, dv): S = 1, S not a multiple of the 64-key tile, S
# over several 128-row packed tiles, groups 1/2/4/8, Dk != Dv, the serving
# head dims.
REGTILE_CASES = [
    (1, 2, 2, 1, 128, 128),
    (2, 4, 2, 100, 128, 128),
    (1, 8, 2, 300, 64, 64),
    (1, 4, 4, 257, 32, 32),
    (1, 8, 2, 200, 24, 16),
    (1, 16, 8, 2079, 128, 128),
    (1, 32, 4, 70, 32, 96),
]


def _bodies(q, k, v, scale, causal):
    regtile0 = kernel.flash_attention_simt_regtile.launches
    basic0 = kernel.flash_attention_simt_basic.launches
    got = kernel.flash_attention_simt_regtile(q, k, v, scale=scale, causal=causal)
    basic = kernel.flash_attention_simt_basic(q, k, v, scale=scale, causal=causal)
    assert kernel.flash_attention_simt_regtile.launches == regtile0 + 1
    assert kernel.flash_attention_simt_basic.launches == basic0 + 1
    return got, basic


@pytest.mark.cuda
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", REGTILE_CASES)
def test_cuda_regtile_matches_plain_and_basic(cuda_device, case, causal):
    arrs = _inputs(*case, seed=case[3] + 1)
    q, k, v = _torch(arrs, device=cuda_device)
    scale = 1.0 / case[4] ** 0.5
    assert kernel.takes_regtile(q, k, v)
    got, basic = _bodies(q, k, v, scale, causal)
    torch.cuda.synchronize()
    for want in (ref.chunked_attention(q, k, v, scale=scale, causal=causal),
                 ref.mha_reference(q, k, v, scale=scale, causal=causal), basic):
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)


@pytest.mark.cuda
def test_cuda_regtile_strided_views(cuda_device):
    """(B, S, H, D) tensors viewed as (B, H, S, D): strides of 16 bytes."""
    rng = np.random.default_rng(16)
    q, k, v = (torch.from_numpy(rng.normal(size=(2, 33, h, 16)).astype(np.float32))
               .to(cuda_device).transpose(1, 2) for h in (4, 2, 2))
    assert not q.is_contiguous() and kernel.takes_regtile(q, k, v)
    for causal in (True, False):
        got, basic = _bodies(q, k, v, 0.25, causal)
        want = ref.mha_reference(q, k, v, scale=0.25, causal=causal)
        torch.cuda.synchronize()
        np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)
        np.testing.assert_allclose(_np(got), _np(basic), atol=F32_ATOL)


def assert_spacing_close(got, want):
    """16-bit: within one spacing of ``want``'s dtype at ``want`` + 2e-5
    (each side rounds its float32 result once)."""
    w = want.float()
    bits = 11 if want.dtype == torch.float16 else 8
    ulp = torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - bits)
    diff = (got.float() - w).abs()
    assert bool((diff <= ulp + F32_ATOL).all()), float((diff - ulp).max())


def _rest_holds(got, q, k, v, scale, causal):
    """The basic body's output against both plain versions: float32 within
    F32_ATOL, 16-bit within one spacing + 2e-5 (and the bf16 rule)."""
    for plain in (ref.chunked_attention, ref.mha_reference):
        want = plain(q, k, v, scale=scale, causal=causal)
        torch.cuda.synchronize()
        assert got.dtype == want.dtype and got.shape == want.shape
        if got.dtype == torch.float32:
            np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)
        else:
            assert_spacing_close(got, want)
            np.testing.assert_allclose(_np(got), _np(want), rtol=BF16_RTOL,
                                       atol=1e-6)


def _through_the_basic_body(q, k, v, scale, causal):
    """One ``kernel.flash_attention`` call that must reach the basic body
    (and neither the register-tiled body nor the Hopper kernel)."""
    wrappers = (kernel.flash_attention_simt, kernel.flash_attention_simt_regtile,
                kernel.flash_attention_simt_basic, kernel.flash_attention_wgmma)
    before = {f: f.launches for f in wrappers}
    got = kernel.flash_attention(q, k, v, scale=scale, causal=causal)
    after = {f: f.launches - n for f, n in before.items()}
    assert after == {kernel.flash_attention_simt: 1,
                     kernel.flash_attention_simt_regtile: 0,
                     kernel.flash_attention_simt_basic: 1,
                     kernel.flash_attention_wgmma: 0}
    return got


@pytest.mark.cuda
@pytest.mark.parametrize("s,causal", [(70, True), (130, False), (1, True),
                                      (37, True), (37, False)])
@pytest.mark.parametrize("dtype,dk,dv", [
    (torch.float32, 256, 256),
    (torch.float32, 192, 128),
    (torch.bfloat16, 16, 16),
    (torch.float16, 16, 16),
    (torch.bfloat16, 96, 96),
    (torch.float16, 96, 96),
    (torch.bfloat16, 256, 256),
    (torch.float16, 256, 256),
    (torch.float32, 136, 72),
])
def test_cuda_rest_reaches_the_basic_body(cuda_device, dtype, dk, dv, s,
                                          causal):
    """Dk or Dv above 128 and 16-bit inputs off the Hopper kernel's head
    dims take the basic body, through the dispatch (S = 1, S under one key
    tile, a ragged S without the causal mask), and the register-tiled
    wrapper refuses them."""
    q, k, v = _torch(_inputs(2, 4, 2, s, dk, dv, seed=17 + s), dtype=dtype,
                     device=cuda_device)
    assert not kernel.takes_regtile(q, k, v) and not kernel.takes_wgmma(q, k, v)
    got = _through_the_basic_body(q, k, v, 0.1, causal)
    _rest_holds(got, q, k, v, 0.1, causal)
    with pytest.raises(ValueError, match="register-tiled"):
        kernel.flash_attention_simt_regtile(q, k, v, scale=0.1)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
def test_cuda_basic_body_unaligned_views(cuda_device, dtype, causal):
    """Rows that 16-byte copies cannot address (a base one element off, a
    row stride of Dk + 1 elements): the element-wise staging."""
    rng = np.random.default_rng(19)
    dk = 24

    def view(h, d):
        flat = torch.from_numpy(rng.normal(size=(1 + 2 * h * 70 * (d + 1),))
                                .astype(np.float32)).to(cuda_device, dtype)
        return flat[1:].view(2, h, 70, d + 1)[..., :d]

    q, k, v = view(4, dk), view(2, dk), view(2, 16)
    assert q.data_ptr() % 16 and q.stride(2) == dk + 1
    got = _through_the_basic_body(q, k, v, 0.2, causal)
    _rest_holds(got, q, k, v, 0.2, causal)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,dk,dv", [
    (torch.float32, 16, 16),
    (torch.float32, 192, 128),
    (torch.bfloat16, 256, 256),
])
def test_cuda_basic_body_group_over_a_block(cuda_device, dtype, dk, dv):
    """G = 256 query heads over one KV head: more than a block's packed
    rows, so the group is split over blocks."""
    q, k, v = _torch(_inputs(1, 256, 1, 75, dk, dv, seed=20), dtype=dtype,
                     device=cuda_device)
    for causal in (True, False):
        got = _through_the_basic_body(q, k, v, 1.0 / dk ** 0.5, causal)
        _rest_holds(got, q, k, v, 1.0 / dk ** 0.5, causal)


@pytest.mark.cuda
def test_cuda_basic_body_mla_layout(cuda_device):
    """MLA's prefill operands (models/attention.py): k the concatenation of
    the nope part and the rope part expanded over heads, v a strided slice
    of the kv_up output, (B, S, H, D) viewed as (B, H, S, D), float32 at
    (192, 128)."""
    rng = np.random.default_rng(21)
    B, S, H, dn, dr, dv = 1, 200, 4, 128, 64, 128

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(np.float32)).to(
            cuda_device)

    kv = t(B, S, H, dn + dv)
    k = torch.cat([kv[..., :dn], t(B, S, 1, dr).expand(B, S, H, dr)], dim=-1)
    q, v = t(B, S, H, dn + dr), kv[..., dn:]
    q, k, v = (x.transpose(1, 2) for x in (q, k, v))
    assert not v.is_contiguous()
    got = _through_the_basic_body(q, k, v, 1.0 / (dn + dr) ** 0.5, True)
    _rest_holds(got, q, k, v, 1.0 / (dn + dr) ** 0.5, True)


@pytest.mark.cuda
def test_cuda_float32_dispatch_reaches_the_register_tiled_body(cuda_device):
    q, k, v = _torch(_inputs(1, 16, 8, 513, 128, 128, seed=18),
                     device=cuda_device)
    regtile0 = kernel.flash_attention_simt_regtile.launches
    simt0 = kernel.flash_attention_simt.launches
    got = ops.attention(q, k, v, causal=True)
    assert kernel.flash_attention_simt_regtile.launches == regtile0 + 1
    assert kernel.flash_attention_simt.launches == simt0 + 1
    want = ref.mha_reference(q, k, v, scale=1.0 / 128 ** 0.5, causal=True)
    torch.cuda.synchronize()
    np.testing.assert_allclose(_np(got), _np(want), atol=F32_ATOL)
