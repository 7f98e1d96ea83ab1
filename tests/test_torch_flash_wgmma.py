"""The Hopper flash kernel's plain version and dispatch rule, against
``repro.kernels.flash_attention``.

The Hopper kernel (``csrc/flash_wgmma.cu``) rounds each tile's softmax
weights ``p = exp(s - m_new)`` to the input dtype before P·V, at its
128-key tile boundaries, while l sums the unrounded weights.  Its plain
version is ``ref.chunked_attention(..., p_dtype=dtype)``.  The
same inputs (seeded numpy) go through it and through JAX's
``mha_reference`` and the Pallas kernel in interpret mode.

Tolerance.  p in [0, 1] rounded to bf16 is off by at most 2^-9 of itself
(fp16: 2^-12), so the output moves by at most 2^-9 max|v| over the keys a
row reads, plus the final rounding to the output dtype.  Held within
``1 spacing(out) + 2^-8 max|v| (per batch x KV head) + 2e-5``: a factor 2
on the rounding term, one output spacing for the final rounding, and the
float32 summation-order atol of the other flash tests.

The ``cuda``-marked tests hold the kernel itself against both plain
versions on the card and skip without one.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import attention as j_attention
from repro.kernels.flash_attention.ref import mha_reference as j_mha
from repro_torch.kernels.flash_attention import kernel, ops, ref
from _torch_threads import one_thread  # noqa: F401 (autouse)

F32_ATOL = 2e-5
P_VREL = 2.0 ** -8
TILE = ref.KEY_TILE
_JNP = {torch.bfloat16: jnp.bfloat16, torch.float16: jnp.float16}


def _inputs(b, hq, hkv, s, dk, dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, dk)).astype(np.float32)
    k = rng.normal(size=(b, hkv, s, dk)).astype(np.float32)
    v = rng.normal(size=(b, hkv, s, dv)).astype(np.float32)
    return q, k, v


def _torch(arrays, dtype, device="cpu"):
    return [torch.from_numpy(a).to(device=device, dtype=dtype) for a in arrays]


def _f32(t) -> torch.Tensor:
    if isinstance(t, torch.Tensor):
        return t.detach().float().cpu()
    return torch.from_numpy(np.asarray(t, np.float32))


def spacing(want: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """The spacing of ``dtype`` (bfloat16: 8 significant bits, float16:
    11) at each value of ``want``."""
    bits = 11 if dtype == torch.float16 else 8
    w = _f32(want)
    return torch.ldexp(torch.ones_like(w), torch.frexp(w).exponent - bits) \
        .clamp_min(2.0 ** -133)


def bound_units(got, want, v: torch.Tensor, group: int,
                dtype: torch.dtype) -> float:
    """Worst |got - want| in units of the stated bound (<= 1 passes)."""
    vmax = _f32(v).abs().amax(dim=(2, 3), keepdim=True)
    tol = spacing(want, dtype) + P_VREL * vmax.repeat_interleave(group, 1) + F32_ATOL
    return float(((_f32(got) - _f32(want)).abs() / tol).max())


def p_plain(q, k, v, *, scale, causal):
    return ref.chunked_attention(q, k, v, scale=scale, causal=causal,
                                 p_dtype=q.dtype)


# (b, hq, hkv, s, dk, dv): groups 1/2/4, S = 1, 100, 257 (a last tile
# holding one key, the rest of it masked), Dk != Dv, the served head dim.
CASES = [
    (1, 2, 2, 1, 64, 64),
    (2, 4, 2, 100, 64, 64),
    (1, 8, 2, 257, 32, 16),
    (1, 4, 2, 257, 24, 24),
    (1, 4, 1, 100, 128, 128),
]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_p_dtype_plain_within_bound_of_jax_mha(case, causal, dtype):
    b, hq, hkv, s, dk, dv = case
    arrs = _inputs(*case, seed=3 * s + hq)
    scale = 1.0 / dk ** 0.5
    q, k, v = _torch(arrs, dtype)
    got = p_plain(q, k, v, scale=scale, causal=causal)
    want = j_mha(*[jnp.asarray(a, _JNP[dtype]) for a in arrs], scale=scale,
                 causal=causal)
    assert got.shape == (b, hq, s, dv) and got.dtype == dtype
    assert bound_units(got, want, v, hq // hkv, dtype) <= 1.0


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("case", [
    (1, 2, 2, 128, 64, 64),    # group 1, one 128 block
    (1, 4, 2, 200, 32, 32),    # group 2, ragged S padded by the reference
    (1, 8, 2, 256, 24, 16),    # group 4, Dk != Dv, two key tiles
])
def test_p_dtype_plain_within_bound_of_interpret_kernel(case, dtype):
    """The Pallas kernel in interpret mode (causal; the reference pads S
    and D and slices back) against the plain version of the Hopper
    kernel."""
    arrs = _inputs(*case, seed=21)
    scale = 1.0 / case[4] ** 0.5
    q, k, v = _torch(arrs, dtype)
    got = p_plain(q, k, v, scale=scale, causal=True)
    want = j_attention(*[jnp.asarray(a, _JNP[dtype]) for a in arrs],
                       scale=scale, causal=True, use_kernel=True,
                       block_q=128, block_k=128)
    assert bound_units(got, want, v, case[1] // case[2], dtype) <= 1.0


def _numpy_rule(q, k, v, scale, causal, tile, round_p):
    """A transcription of the kernel's rule in float64 numpy, one (batch,
    head) at a time: 128-key tiles in order, m, l and acc carried across
    tiles, p rounded by ``round_p`` before P·V, l from the unrounded p."""
    b, hq, s, _ = q.shape
    group = hq // k.shape[1]
    out = np.zeros((b, hq, s, v.shape[-1]))
    for bi in range(b):
        for h in range(hq):
            qh, kh, vh = q[bi, h], k[bi, h // group], v[bi, h // group]
            m = np.full(s, -1e30)
            l = np.zeros(s)
            acc = np.zeros((s, v.shape[-1]))
            for k0 in range(0, s, tile):
                sc = (qh @ kh[k0:k0 + tile].T) * scale
                if causal:
                    cols = np.arange(k0, min(k0 + tile, s))
                    sc = np.where(np.arange(s)[:, None] >= cols[None, :], sc, -1e30)
                m_new = np.maximum(m, sc.max(-1))
                p = np.exp(sc - m_new[:, None])
                alpha = np.exp(m - m_new)
                l = l * alpha + p.sum(-1)
                acc = acc * alpha[:, None] + round_p(p) @ vh[k0:k0 + tile]
                m = m_new
            out[bi, h] = acc / np.where(l > 0, l, 1.0)[:, None]
    return out


@pytest.mark.parametrize("causal", [True, False])
def test_p_dtype_rule_matches_numpy_transcription(causal):
    """float32 inputs with p rounded to bf16: the plain version follows an
    independent float64 transcription of the rule.  Where the two p's lie
    on either side of a bf16 rounding boundary they round apart (one p
    spacing, at most 2^-8 max|v| on the output), so a few elements in a
    thousand may differ by more than the summation-order atol; without the
    rounding (or with it at other places) most of them do."""
    q, k, v = _inputs(1, 4, 2, 300, 32, 24, seed=5)
    scale = 1.0 / 32 ** 0.5
    tq, tk, tv = _torch((q, k, v), torch.float32)
    got = ref.chunked_attention(tq, tk, tv, scale=scale, causal=causal,
                                p_dtype=torch.bfloat16).numpy()

    def round_bf16(p):
        return torch.from_numpy(p).to(torch.bfloat16).double().numpy()

    want = _numpy_rule(q, k, v, scale, causal, TILE, round_bf16)
    unrounded = ref.chunked_attention(tq, tk, tv, scale=scale,
                                      causal=causal).numpy()
    diff, off = np.abs(got - want), np.abs(unrounded - want)
    assert np.median(diff) < 1e-6
    assert (diff > F32_ATOL).mean() < 0.01 < 0.5 < (off > F32_ATOL).mean()
    assert diff.max() <= P_VREL * np.abs(v).max()


def test_default_path_unchanged():
    """Without p_dtype the plain version is the float32 online softmax of
    the other flash tests (held against JAX), bit for bit whatever the
    spelling, and it is what ``ops.attention`` runs on a CPU tensor."""
    arrs = _inputs(1, 4, 2, 257, 32, 32, seed=6)
    scale = 1.0 / 32 ** 0.5
    for dtype in (torch.float32, torch.bfloat16):
        q, k, v = _torch(arrs, dtype)
        base = ref.chunked_attention(q, k, v, scale=scale, causal=True)
        same = ref.chunked_attention(q, k, v, scale=scale, causal=True,
                                     p_dtype=None)
        assert torch.equal(base, same)
        assert torch.equal(ops.attention(q, k, v, scale=scale), base)
    q, k, v = _torch(arrs, torch.float32)
    want = j_mha(*[jnp.asarray(a) for a in arrs], scale=scale, causal=True)
    np.testing.assert_allclose(
        ref.chunked_attention(q, k, v, scale=scale).numpy(),
        np.asarray(want), atol=F32_ATOL)


# ---------------------------------------------------------------------------
# The dispatch rule (a function of the inputs alone: testable on the CPU)
# ---------------------------------------------------------------------------

def _qkv(dtype, dk, dv, s=64, hq=4, hkv=2):
    return (torch.zeros(1, hq, s, dk, dtype=dtype),
            torch.zeros(1, hkv, s, dk, dtype=dtype),
            torch.zeros(1, hkv, s, dv, dtype=dtype))


@pytest.mark.parametrize("dtype,dk,dv,hopper", [
    (torch.bfloat16, 128, 128, True),
    (torch.float16, 128, 128, True),
    (torch.bfloat16, 64, 64, True),
    (torch.float16, 192, 128, True),
    (torch.float32, 128, 128, False),
    (torch.bfloat16, 16, 16, False),
    (torch.bfloat16, 96, 96, False),
    (torch.float16, 128, 64, False),
])
def test_dispatch_rule_by_dtype_and_head_dims(dtype, dk, dv, hopper):
    assert kernel.takes_wgmma(*_qkv(dtype, dk, dv)) is hopper


def test_dispatch_rule_strides_and_alignment():
    """The serve layout (transposed (B, S, H, D) views) takes the Hopper
    kernel; a base off 16 bytes or a stride off 8 elements does not;
    a length-1 axis may have any stride."""
    s, hq, hkv, d = 100, 16, 8, 128
    q = torch.zeros(1, s, hq, d, dtype=torch.bfloat16).transpose(1, 2)
    k = torch.zeros(1, s, hkv, d, dtype=torch.bfloat16).transpose(1, 2)
    assert not q.is_contiguous() and kernel.takes_wgmma(q, k, k)
    flat = torch.zeros(hq * s * d + 8, dtype=torch.bfloat16)
    off = flat[1:1 + hq * s * d].view(1, hq, s, d)
    assert off.data_ptr() % 16 != 0 and not kernel.takes_wgmma(off, k, k)
    wide = torch.zeros(1, hkv, s, d + 4, dtype=torch.bfloat16)[..., :d]
    assert wide.stride(2) % 8 != 0 and not kernel.takes_wgmma(q, wide, wide)
    one = torch.zeros(1, 1, 1, d, dtype=torch.bfloat16).as_strided(
        (1, 1, 1, d), (3, 5, 7, 1))
    assert kernel.takes_wgmma(one, one, one)
    assert kernel._strides(one) == (d, d, d)
    assert kernel._strides(q) == (s * hq * d, d, hq * d)


def test_wrappers_refuse_cpu_tensors():
    q, k, v = _qkv(torch.bfloat16, 128, 128)
    for fn in (kernel.flash_attention, kernel.flash_attention_wgmma,
               kernel.flash_attention_simt):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, scale=0.25)


# ---------------------------------------------------------------------------
# On the card: the Hopper kernel against both plain versions
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
@pytest.mark.parametrize("dims", sorted(kernel.WGMMA_HEAD_DIMS))
@pytest.mark.parametrize("s,hq,hkv,causal", [
    (1, 2, 2, True), (100, 4, 2, True), (257, 8, 2, False),
    (300, 4, 1, True), (2049, 4, 2, True),
])
def test_cuda_wgmma_matches_both_plain_versions(cuda_device, dtype, dims, s,
                                                hq, hkv, causal):
    dk, dv = dims
    arrs = _inputs(1, hq, hkv, s, dk, dv, seed=s + dk)
    q, k, v = _torch(arrs, dtype, device=cuda_device)
    scale = 1.0 / dk ** 0.5
    before = (kernel.flash_attention_wgmma.launches,
              kernel.flash_attention_simt.launches)
    got = ops.attention(q, k, v, scale=scale, causal=causal)
    assert (kernel.flash_attention_wgmma.launches,
            kernel.flash_attention_simt.launches) == (before[0] + 1, before[1])
    assert got.dtype == dtype and got.shape == (1, hq, s, dv)
    for want in (p_plain(q, k, v, scale=scale, causal=causal),
                 ref.mha_reference(q, k, v, scale=scale, causal=causal)):
        torch.cuda.synchronize()
        assert bound_units(got, want, v, hq // hkv, dtype) <= 1.0


@pytest.mark.cuda
def test_cuda_wgmma_serve_layout(cuda_device):
    """Transposed (B, S, H, D) views, as ``gqa.apply`` passes them."""
    s, hq, hkv, d = 640, 16, 8, 128
    rng = np.random.default_rng(31)
    q, k, v = [torch.from_numpy(rng.normal(size=(2, s, h, d)).astype(np.float32))
               .to(cuda_device, torch.bfloat16).transpose(1, 2)
               for h in (hq, hkv, hkv)]
    got = kernel.flash_attention(q, k, v, scale=d ** -0.5, causal=True)
    want = p_plain(q, k, v, scale=d ** -0.5, causal=True)
    torch.cuda.synchronize()
    assert bound_units(got, want, v, hq // hkv, torch.bfloat16) <= 1.0


@pytest.mark.cuda
def test_cuda_dispatch_sends_the_rest_to_the_cuda_core_kernel(cuda_device):
    for dtype, dk, dv in ((torch.float32, 128, 128), (torch.bfloat16, 16, 16)):
        q, k, v = [t.to(cuda_device) for t in _qkv(dtype, dk, dv)]
        before = (kernel.flash_attention_wgmma.launches,
                  kernel.flash_attention_simt.launches)
        kernel.flash_attention(q, k, v, scale=0.25)
        assert (kernel.flash_attention_wgmma.launches,
                kernel.flash_attention_simt.launches) == (before[0], before[1] + 1)


@pytest.mark.cuda
def test_cuda_wgmma_refuses_unsupported_inputs(cuda_device):
    q, k, v = [t.to(cuda_device) for t in _qkv(torch.float32, 128, 128)]
    with pytest.raises(TypeError):
        kernel.flash_attention_wgmma(q, k, v, scale=0.25)
    q, k, v = [t.to(cuda_device) for t in _qkv(torch.bfloat16, 96, 96)]
    with pytest.raises(ValueError, match="wgmma kernel is built for"):
        kernel.flash_attention_wgmma(q, k, v, scale=0.25)
    flat = torch.zeros(4 * 64 * 128 + 8, dtype=torch.bfloat16, device=cuda_device)
    off = flat[1:1 + 4 * 64 * 128].view(1, 4, 64, 128)
    _, k, v = [t.to(cuda_device) for t in _qkv(torch.bfloat16, 128, 128)]
    with pytest.raises(ValueError, match="TMA"):
        kernel.flash_attention_wgmma(off, k, v, scale=0.25)
