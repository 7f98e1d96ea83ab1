"""The basic flash body's route, on the CPU.

``csrc/flash_attention.cu``'s basic body (namespace ``basic``) takes every
input the register-tiled body refuses: float32 above head dim 128, 16-bit
inputs off the Hopper kernel's head dims, unaligned rows and more query
heads a KV head than a block has rows.  It computes
``ref.chunked_attention`` by the register-tiled body's route, widened:

* ``_rows(Dk, Dv, dtype)`` packed query rows a block (the source's
  ``rows_for``, copied here and held against the kernel's own
  ``flash_attention_basic_smem`` on the card): ``ROWS`` up to head dim
  ``NARROW_D`` (float32: up to Dk = ``WIDE_DK`` at Dv <= ``NARROW_D``,
  with one K buffer), ``WIDE_ROWS`` above;
* a block packs G_b = min(G, rows) heads of a KV head's group,
  rows // G_b q rows of each, head after head; where G exceeds the
  block's rows the group is split over ceil(G / rows) blocks (a head
  group each); blocks are numbered longest first (the last q tile of
  every (head group, KV head, batch) first);
* key tiles of ``KEYS`` keys up to the causal stop of the block's
  last query row; inside a packed tile each row keeps its own causal
  limit, keys at index >= S weigh exactly 0 (their K and V rows are
  zero-filled), rows at index >= S (or past the group) are not written;
* 16-bit inputs are converted to float32 as they are staged, and the
  float32 result is rounded to the input dtype once.

``_replay`` repeats that route in numpy float32 and is held against
``ref.chunked_attention``, ``ref.mha_reference`` and the JAX package's
kernel (``ops.attention(use_kernel=True)``, interpret mode on the CPU, at
block multiples) at atol 2e-5, the bound
``tests/test_torch_flash_attention.py`` holds the port to: the sums are
the same in float32 and differ in order only.  The kernel itself is held
against the plain versions on the card (the ``cuda`` tests there and
``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import attention as j_attention
from repro_torch.kernels.flash_attention import kernel, ref
from _torch_threads import one_thread  # noqa: F401 (autouse)

F32 = np.float32
F32_ATOL = 2e-5
NEG = F32(-1e30)
# The basic body's rows a block and keys a K/V tile (``rows_for`` and
# ``kKeys`` in csrc/flash_attention.cu).
ROWS, WIDE_ROWS, NARROW_D, WIDE_DK, KEYS = 128, 64, 128, 192, 64
# The most shared memory a block may opt in to on an H100 (227 KB).
SMEM_MAX = 232448


def _rows(dk, dv, dtype):
    """Packed query rows a block at head dims (Dk, Dv): ROWS up to
    NARROW_D, and for float32 up to Dk = WIDE_DK at Dv <= NARROW_D (Q, one
    K tile, V and P still fit a block's shared memory); WIDE_ROWS above
    (so that a lane's output rows stay in registers at Dv = 256, and a
    16-bit tile loaded ahead in registers beside them)."""
    if dv > NARROW_D:
        return WIDE_ROWS
    return ROWS if dk <= (WIDE_DK if dtype == torch.float32 else NARROW_D) \
        else WIDE_ROWS


def _inputs(b, hq, hkv, s, dk, dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, dk)).astype(F32)
    k = rng.normal(size=(b, hkv, s, dk)).astype(F32)
    v = rng.normal(size=(b, hkv, s, dv)).astype(F32)
    return q, k, v


def _layout(G, dk, dv, dtype=torch.float32):
    """(rows a block, heads a block, q rows of each, head groups)."""
    rows = _rows(dk, dv, dtype)
    gb = min(G, rows)
    return rows, gb, rows // gb, -(-G // gb)


def _blocks(S, Hq, Hkv, B, dk, dv, dtype=torch.float32):
    """The body's grid in launch order: (q0, first head of the group, KV
    head, batch)."""
    _, gb, qr, n_hg = _layout(Hq // Hkv, dk, dv, dtype)
    nq = -(-S // qr)
    heads = n_hg * Hkv * B
    for bid in range(nq * heads):
        wave, hb = divmod(bid, heads)
        hg, hk, b = hb % n_hg, (hb // n_hg) % Hkv, hb // (n_hg * Hkv)
        yield (nq - 1 - wave) * qr, hg * gb, hk, b


def _n_tiles(S, q0, qr, causal):
    tiles = -(-S // KEYS)
    return min(tiles, (min(q0 + qr, S) - 1) // KEYS + 1) if causal else tiles


def _replay(q, k, v, scale, causal, dtype=torch.float32):
    """The basic body's route for inputs of ``dtype`` (its row layout), in
    numpy float32 on inputs already converted to float32; also returns
    how many times each output row was written."""
    B, Hq, S, Dk = q.shape
    Hkv, Dv = k.shape[1], v.shape[-1]
    G = Hq // Hkv
    rows, gb, qr, _ = _layout(G, Dk, Dv, dtype)
    out = np.full((B, Hq, S, Dv), np.nan, F32)
    writes = np.zeros((B, Hq, S), np.int64)
    scale = F32(scale)
    for q0, g0, hk, b in _blocks(S, Hq, Hkv, B, Dk, Dv, dtype):
        pr = np.arange(rows)
        gl, row = pr // qr, q0 + pr % qr
        head = hk * G + g0 + gl
        live = (gl < gb) & (g0 + gl < G) & (row < S)
        qp = np.zeros((rows, Dk), F32)
        qp[live] = q[b, head[live], row[live]]
        m = np.full(rows, NEG, F32)
        l = np.zeros(rows, F32)
        acc = np.zeros((rows, Dv), F32)
        for t in range(_n_tiles(S, q0, qr, causal)):
            col = t * KEYS + np.arange(KEYS)
            inside = col < S
            kt = np.zeros((KEYS, Dk), F32)
            vt = np.zeros((KEYS, Dv), F32)
            kt[inside] = k[b, hk, col[inside]]
            vt[inside] = v[b, hk, col[inside]]
            s = (qp @ kt.T) * scale
            dead = ~inside[None, :]
            if causal:
                dead = dead | (row[:, None] < col[None, :])
            s = np.where(dead, NEG, s).astype(F32)
            m_new = np.maximum(m, s.max(axis=1))
            alpha = np.exp(m - m_new)
            p = np.where(inside[None, :], np.exp(s - m_new[:, None]), F32(0))
            l = l * alpha + p.sum(axis=1, dtype=F32)
            acc = acc * alpha[:, None] + p @ vt
            m = m_new
        safe_l = np.where(l > 0, l, F32(1))
        o = acc / safe_l[:, None]
        out[b, head[live], row[live]] = o[live]
        writes[b, head[live], row[live]] += 1
    return out, writes


def _hold(got, q, k, v, scale, causal):
    """Against both plain versions (``ref.mha_reference`` is itself held
    against the JAX package's in ``tests/test_torch_flash_attention.py``)."""
    tq = [torch.from_numpy(a) for a in (q, k, v)]
    for plain in (ref.chunked_attention, ref.mha_reference):
        want = plain(*tq, scale=scale, causal=causal).numpy()
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


# (b, hq, hkv, s, dk, dv, the dtype whose row layout is replayed): both
# row counts ((8, 8) and float32's (192, 128) and (136, 72) at 128 rows;
# 16-bit (192, 128) and (136, 72), (256, 256) at 64), groups 1, 2 and 4,
# S = 1, S inside one key tile, S one past a key tile, ragged S over
# several q tiles.
BF16 = torch.bfloat16
CASES = [
    (1, 2, 2, 1, 8, 8, torch.float32),
    (1, 8, 2, 150, 8, 8, torch.float32),
    (1, 2, 2, 160, 192, 128, torch.float32),
    (1, 4, 2, KEYS + 1, 192, 128, BF16),
    (1, 4, 4, 100, 256, 256, torch.float32),
    (2, 8, 2, 97, 136, 72, torch.float32),
    (1, 4, 1, 40, 136, 72, BF16),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_route_matches_plain_versions(case, causal):
    q, k, v = _inputs(*case[:6], seed=case[3] + case[1] + case[4])
    scale = 1.0 / case[4] ** 0.5
    got, writes = _replay(q, k, v, scale, causal, case[6])
    assert (writes == 1).all()
    _hold(got, q, k, v, scale, causal)


@pytest.mark.parametrize("case", [
    (1, 2, 2, 128, 192, 128, torch.float32),  # MLA's head dims, group 1
    (1, 4, 2, 128, 192, 128, BF16),           # 64 rows a block, group 2
    (1, 4, 2, 128, 8, 8, torch.float32),      # group 2, 128 rows a block
])
def test_route_matches_interpret_kernel_causal(case):
    """The Pallas kernel in interpret mode at block multiples (the
    reference pads D and slices back)."""
    q, k, v = _inputs(*case[:6], seed=31)
    scale = 1.0 / case[4] ** 0.5
    got, _ = _replay(q, k, v, scale, True, case[6])
    want = j_attention(*(jnp.asarray(a) for a in (q, k, v)), scale=scale,
                       causal=True, use_kernel=True, block_q=128, block_k=128)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=0)


def test_route_matches_interpret_kernel_non_causal_block_multiple():
    q, k, v = _inputs(1, 2, 1, 128, 136, 72, seed=32)
    got, _ = _replay(q, k, v, 1.0 / 136 ** 0.5, False, BF16)
    want = j_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=False,
                       use_kernel=True, block_q=128, block_k=128)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("hq,dk,dv", [
    (160, 8, 8),       # 128 rows a block: 128 heads and 32, one row each
    (80, 256, 256),    # 64 rows a block: 64 heads and 16
])
def test_group_split_over_blocks(hq, dk, dv):
    """A group of more heads than a block has rows is split over head
    groups of a row each; every (head, row) is written once."""
    rows, gb, qr, n_hg = _layout(hq, dk, dv)
    assert gb == rows and qr == 1 and n_hg == 2
    q, k, v = _inputs(1, hq, 1, 24, dk, dv, seed=33)
    for causal in (True, False):
        got, writes = _replay(q, k, v, 1.0 / dk ** 0.5, causal)
        assert (writes == 1).all()
        _hold(got, q, k, v, 1.0 / dk ** 0.5, causal)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16])
def test_16bit_inputs_round_once(dtype):
    """16-bit inputs converted to float32 as they are staged, the float32
    result rounded once: within one output spacing + 2e-5 of
    ``ref.chunked_attention`` on the 16-bit tensors."""
    arrs = _inputs(1, 4, 2, 90, 96, 96, seed=34)
    tq = [torch.from_numpy(a).to(dtype) for a in arrs]
    got, _ = _replay(*(t.float().numpy() for t in tq), 0.1, True, dtype)
    got = torch.from_numpy(got).to(dtype).float()
    want = ref.chunked_attention(*tq, scale=0.1, causal=True).float()
    bits = 11 if dtype == torch.float16 else 8
    ulp = torch.ldexp(torch.ones_like(want), torch.frexp(want).exponent - bits)
    assert bool(((got - want).abs() <= ulp + F32_ATOL).all())


def test_packed_rows_keep_their_own_causal_limit():
    """Within one packed tile the rows of every head see keys up to their
    own position: a value planted at key j reaches row i of each head only
    when j <= i (64 rows a block, group 4)."""
    S, G, Dk = 100, 4, 256
    q = np.zeros((1, G, S, Dk), F32)
    k = np.zeros((1, 1, S, Dk), F32)
    v = np.zeros((1, 1, S, 256), F32)
    v[0, 0, 37, 0] = 1.0  # uniform weights, one marked key
    got, _ = _replay(q, k, v, 1.0, True)
    rows = np.arange(S)
    want = np.where(rows >= 37, 1.0 / (rows + 1), 0.0).astype(F32)
    for h in range(G):
        np.testing.assert_allclose(got[0, h, :, 0], want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("S,G,dk,dv,dtype", [
    (2079, 1, 192, 128, torch.float32), (2079, 2, 192, 128, BF16),
    (2079, 2, 128, 128, torch.float32), (1000, 4, 256, 256, BF16),
    (150, 256, 8, 8, torch.float32), (64, 8, 136, 72, torch.float16),
])
def test_blocks_longest_first_and_cover_every_row(S, G, dk, dv, dtype):
    """Under causal masking block i has at least as many key tiles as block
    i + 1, the grid covers every (head, row) once, and each block's tiles
    reach its last row and no further."""
    Hkv, B = 3, 2
    rows, gb, qr, _ = _layout(G, dk, dv, dtype)
    blocks = list(_blocks(S, G * Hkv, Hkv, B, dk, dv, dtype))
    work = [_n_tiles(S, q0, qr, True) for q0, *_ in blocks]
    assert work == sorted(work, reverse=True)
    seen = np.zeros((B, G * Hkv, S), np.int64)
    for q0, g0, hk, b in blocks:
        for g in range(g0, min(g0 + gb, G)):
            seen[b, hk * G + g, q0:min(q0 + qr, S)] += 1
    assert (seen == 1).all()
    assert all(_n_tiles(S, q0, qr, True) * KEYS >= min(q0 + qr, S)
               > (_n_tiles(S, q0, qr, True) - 1) * KEYS for q0, *_ in blocks)


def _smem(rows, dk, dv, kbuf):
    """The body's shared memory: Q and kbuf K tiles at row stride Dk + 4,
    one V tile, P at row stride KEYS + 16, float32."""
    return 4 * ((rows + kbuf * KEYS) * (dk + 4) + KEYS * dv + rows * (KEYS + 16))


def test_rows_and_buffers_fit_every_head_dim():
    """128 rows up to head dim 128 (float32: up to Dk = 192 at Dv <= 128)
    and 64 above; K double-buffered where that fits the 227 KB a block may
    hold, else single-buffered, and every pair of head dims (multiples of
    8 up to 256) fits one way for every dtype."""
    f32 = torch.float32
    for dtype in (f32, BF16, torch.float16):
        assert _rows(128, 128, dtype) == ROWS == 128
        assert _rows(8, 8, dtype) == 128
        for dims in ((128, 136), (256, 256), (8, 256), (200, 128)):
            assert _rows(*dims, dtype) == WIDE_ROWS == 64
    for dims in ((136, 72), (192, 128)):
        assert _rows(*dims, f32) == 128
        assert _rows(*dims, BF16) == 64
    # MLA's float32 (192, 128): 128 rows with one K tile (219 KB), not two.
    assert _smem(128, 192, 128, 2) > SMEM_MAX >= _smem(128, 192, 128, 1) == 224256
    assert _smem(64, 192, 128, 2) == 203776 <= SMEM_MAX       # 16-bit: 2 K tiles
    assert _smem(64, 256, 256, 2) > SMEM_MAX >= _smem(64, 256, 256, 1)
    assert _smem(128, 128, 128, 2) <= SMEM_MAX
    for dk in range(8, 257, 8):
        for dv in range(8, 257, 8):
            for dtype in (f32, BF16):
                rows = _rows(dk, dv, dtype)
                assert _smem(rows, dk, dv, 1) <= SMEM_MAX


@pytest.mark.cuda
def test_rows_and_smem_match_the_kernel():
    """The rows rule and the shared-memory reckoning above are the
    kernel's: ``flash_attention_basic_smem`` reports ``_rows`` and
    ``_smem`` (K double-buffered where that fits) at every pair of head
    dims, for float32 and 16-bit inputs."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    lib = kernel.load_library().lib
    for dk in range(8, 257, 8):
        for dv in range(8, 257, 8):
            for dtype in (torch.float32, BF16):
                rows = _rows(dk, dv, dtype)
                kbuf = 2 if _smem(rows, dk, dv, 2) <= SMEM_MAX else 1
                packed = int(lib.flash_attention_basic_smem(
                    dk, dv, int(dtype == torch.float32)))
                assert (packed >> 32, packed & 0xFFFFFFFF) == (
                    rows, _smem(rows, dk, dv, kbuf)), (dk, dv, dtype)


def _qkv(dtype, dk, dv, hq=4, hkv=2, s=8):
    return (torch.zeros(1, hq, s, dk, dtype=dtype),
            torch.zeros(1, hkv, s, dk, dtype=dtype),
            torch.zeros(1, hkv, s, dv, dtype=dtype))


@pytest.mark.parametrize("dtype,dk,dv,hq,hkv,body", [
    (torch.float32, 192, 128, 4, 2, "basic"),      # MLA's float32 prefill
    (torch.float32, 256, 256, 4, 2, "basic"),
    (torch.float32, 128, 128, 4, 2, "regtile"),
    (torch.float32, 16, 16, 128, 1, "regtile"),
    (torch.float32, 16, 16, 256, 1, "basic"),      # more heads than 128 rows
    (torch.bfloat16, 256, 256, 4, 2, "basic"),     # Gemma 2's head dim
    (torch.float16, 96, 96, 4, 2, "basic"),
    (torch.bfloat16, 16, 16, 4, 2, "basic"),
    (torch.bfloat16, 192, 128, 4, 2, "wgmma"),
    (torch.float16, 128, 128, 4, 2, "wgmma"),
])
def test_dispatch_rule(dtype, dk, dv, hq, hkv, body):
    """Which kernel and body ``kernel.flash_attention`` names for an input
    (the rules run on CPU tensors)."""
    q, k, v = _qkv(dtype, dk, dv, hq=hq, hkv=hkv)
    wgmma = kernel.takes_wgmma(q, k, v)
    regtile = not wgmma and kernel.takes_regtile(q, k, v)
    assert {"wgmma": (True, False), "regtile": (False, True),
            "basic": (False, False)}[body] == (wgmma, regtile)


def test_dispatch_rule_unaligned_rows_take_the_basic_body():
    off = torch.zeros(1 * 4 * 8 * 16 + 1)[1:].view(1, 4, 8, 16)
    k = torch.zeros(1, 2, 8, 16)
    assert not kernel.takes_regtile(off, k, k)
    wide = torch.zeros(1, 2, 8, 17)[..., :16]  # row stride of 17 elements
    assert not kernel.takes_regtile(torch.zeros(1, 4, 8, 16), wide, wide)
    half = torch.zeros(1, 4, 8, 129, dtype=torch.bfloat16)[..., 1:]
    assert not kernel.takes_wgmma(half, half[:, :2], half[:, :2])
    with pytest.raises(ValueError, match="CUDA"):
        kernel.flash_attention_simt_basic(off, k, k, scale=0.25)
