"""The register-tiled float32 flash body's route, on the CPU.

``csrc/flash_attention.cu``'s register-tiled body computes
``ref.chunked_attention`` by another route:

* one block per (``REGTILE_ROWS`` packed query rows, KV head, batch): the
  G = Hq/Hkv query heads of the KV head, ``REGTILE_ROWS // G`` rows of
  each, packed head after head, so that one staged K/V tile serves the
  whole group; blocks are numbered longest first (the last q tile of
  every (KV head, batch) first);
* key tiles of ``REGTILE_KEYS`` keys, up to the causal stop of the
  block's last query row; inside a packed tile each row keeps its own
  causal limit, keys at index >= S weigh exactly 0 (their K and V rows
  are zero-filled), and rows at index >= S (or past G heads) are not
  written;
* the online softmax rescales m, l and the accumulator at each tile edge
  and divides by safe_l at the end.

``_replay`` repeats that route in numpy float32 and is held against
``ref.chunked_attention``, ``ref.mha_reference`` and the JAX package's
kernel (``ops.attention(use_kernel=True)``, interpret mode on the CPU) at
atol 2e-5, the bound ``tests/test_torch_flash_attention.py`` holds the
port to: the sums are the same in float32 and differ in order only.  A
non-causal call at an S that is not a block multiple is held against
``mha_reference`` only: the reference lets its zero-padded keys into that
softmax.  The kernel itself is held against the plain versions on the
card (``tests/test_torch_flash_attention.py``, ``chip_smoke.py``).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels.flash_attention.ops import attention as j_attention
from repro.kernels.flash_attention.ref import mha_reference as j_mha
from repro_torch.kernels.flash_attention import kernel, ref
from _torch_threads import one_thread  # noqa: F401 (autouse)

F32 = np.float32
F32_ATOL = 2e-5
NEG = F32(-1e30)
ROWS, KEYS = kernel.REGTILE_ROWS, kernel.REGTILE_KEYS


def _inputs(b, hq, hkv, s, dk, dv, seed):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(b, hq, s, dk)).astype(F32)
    k = rng.normal(size=(b, hkv, s, dk)).astype(F32)
    v = rng.normal(size=(b, hkv, s, dv)).astype(F32)
    return q, k, v


def _blocks(S, Hq, Hkv, B):
    """The body's grid in launch order: (q0, KV head, batch, rows a head)."""
    qr = ROWS // (Hq // Hkv)
    nq = -(-S // qr)
    for bid in range(nq * Hkv * B):
        wave, hb = divmod(bid, Hkv * B)
        b, hk = divmod(hb, Hkv)
        yield (nq - 1 - wave) * qr, hk, b, qr


def _n_tiles(S, q0, qr, causal):
    tiles = -(-S // KEYS)
    return min(tiles, (min(q0 + qr, S) - 1) // KEYS + 1) if causal else tiles


def _replay(q, k, v, scale, causal):
    """The register-tiled body's route in numpy float32; also returns how
    many times each output row was written."""
    B, Hq, S, Dk = q.shape
    Hkv, Dv = k.shape[1], v.shape[-1]
    G = Hq // Hkv
    out = np.full((B, Hq, S, Dv), np.nan, F32)
    writes = np.zeros((B, Hq, S), np.int64)
    scale = F32(scale)
    for q0, hk, b, qr in _blocks(S, Hq, Hkv, B):
        pr = np.arange(ROWS)
        g, row = pr // qr, q0 + pr % qr
        live = (g < G) & (row < S)
        qp = np.zeros((ROWS, Dk), F32)
        qp[live] = q[b, hk * G + g[live], row[live]]
        m = np.full(ROWS, NEG, F32)
        l = np.zeros(ROWS, F32)
        acc = np.zeros((ROWS, Dv), F32)
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
        out[b, hk * G + g[live], row[live]] = o[live]
        writes[b, hk * G + g[live], row[live]] += 1
    return out, writes


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


# (b, hq, hkv, s, dk, dv): groups 1, 2 and 4, Dk != Dv, S = 1, S inside one
# key tile, S one past a key tile, ragged S over several q tiles.
CASES = [
    (1, 2, 2, 1, 16, 16),
    (1, 2, 2, 150, 32, 32),
    (2, 4, 2, 200, 48, 32),
    (1, 8, 2, 129, 24, 16),
    (1, 4, 2, KEYS + 1, 16, 24),
    (1, 8, 2, 300, 32, 32),
]


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("case", CASES)
def test_route_matches_plain_versions(case, causal):
    q, k, v = _inputs(*case, seed=case[3] + case[1])
    scale = 1.0 / case[4] ** 0.5
    got, writes = _replay(q, k, v, scale, causal)
    assert (writes == 1).all()
    tq = _torch((q, k, v))
    for plain in (ref.chunked_attention, ref.mha_reference):
        want = plain(*tq, scale=scale, causal=causal).numpy()
        np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)
    want = np.asarray(j_mha(*(jnp.asarray(a) for a in (q, k, v)), scale=scale,
                            causal=causal))
    np.testing.assert_allclose(got, want, atol=F32_ATOL, rtol=0)


@pytest.mark.parametrize("case", [
    (1, 2, 2, 200, 32, 32),    # group 1, S padded by the reference
    (1, 4, 2, 130, 64, 64),    # group 2
    (1, 8, 2, 128, 24, 16),    # group 4, Dk != Dv
])
def test_route_matches_interpret_kernel_causal(case):
    """The Pallas kernel in interpret mode (the reference pads S and D and
    slices back)."""
    q, k, v = _inputs(*case, seed=21)
    scale = 1.0 / case[4] ** 0.5
    got, _ = _replay(q, k, v, scale, True)
    want = j_attention(*(jnp.asarray(a) for a in (q, k, v)), scale=scale,
                       causal=True, use_kernel=True, block_q=128, block_k=128)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=0)


def test_route_matches_interpret_kernel_non_causal_block_multiple():
    q, k, v = _inputs(1, 4, 2, 256, 32, 32, seed=22)
    got, _ = _replay(q, k, v, 1.0 / 32 ** 0.5, False)
    want = j_attention(*(jnp.asarray(a) for a in (q, k, v)), causal=False,
                       use_kernel=True, block_q=128, block_k=128)
    np.testing.assert_allclose(got, np.asarray(want), atol=F32_ATOL, rtol=0)


def test_packed_rows_keep_their_own_causal_limit():
    """Within one packed tile the rows of every head see keys up to their
    own position: a value planted at key j reaches row i of each head only
    when j <= i."""
    S, G, Dk = 100, 4, 16
    q = np.zeros((1, G, S, Dk), F32)
    k = np.zeros((1, 1, S, Dk), F32)
    v = np.zeros((1, 1, S, 8), F32)
    v[0, 0, 37, 0] = 1.0  # uniform weights, one marked key
    got, _ = _replay(q, k, v, 1.0, True)
    rows = np.arange(S)
    want = np.where(rows >= 37, 1.0 / (rows + 1), 0.0).astype(F32)
    for h in range(G):
        np.testing.assert_allclose(got[0, h, :, 0], want, atol=1e-7, rtol=0)


@pytest.mark.parametrize("S,G", [(2079, 2), (2079, 1), (1000, 4), (64, 8)])
def test_blocks_longest_first_and_cover_every_row(S, G):
    """Under causal masking block i has at least as many key tiles as block
    i + 1, and the grid covers every (head, row) once."""
    Hkv, B = 3, 2
    blocks = list(_blocks(S, G * Hkv, Hkv, B))
    work = [_n_tiles(S, q0, qr, True) for q0, _, _, qr in blocks]
    assert work == sorted(work, reverse=True)
    seen = np.zeros((B, G * Hkv, S), np.int64)
    for q0, hk, b, qr in blocks:
        for g in range(G):
            seen[b, hk * G + g, q0:min(q0 + qr, S)] += 1
    assert (seen == 1).all()
    qr = ROWS // G
    assert all(_n_tiles(S, q0, qr, True) * KEYS >= min(q0 + qr, S)
               > (_n_tiles(S, q0, qr, True) - 1) * KEYS for q0, *_ in blocks)


def _qkv(dtype, dk, dv, hq=4, hkv=2, s=8):
    q = torch.zeros(1, hq, s, dk, dtype=dtype)
    k = torch.zeros(1, hkv, s, dk, dtype=dtype)
    v = torch.zeros(1, hkv, s, dv, dtype=dtype)
    return q, k, v


@pytest.mark.parametrize("dtype,dk,dv,regtile", [
    (torch.float32, 128, 128, True),
    (torch.float32, 64, 64, True),
    (torch.float32, 16, 16, True),
    (torch.float32, 24, 16, True),
    (torch.float32, 8, 128, True),
    (torch.float32, 192, 128, False),
    (torch.float32, 128, 192, False),
    (torch.float32, 256, 256, False),
    (torch.bfloat16, 128, 128, False),
    (torch.float16, 16, 16, False),
])
def test_body_rule_by_dtype_and_head_dims(dtype, dk, dv, regtile):
    assert kernel.takes_regtile(*_qkv(dtype, dk, dv)) is regtile


def test_body_rule_strides_alignment_and_group():
    q, k, v = _qkv(torch.float32, 16, 16)
    view = torch.zeros(1, 8, 4, 16).transpose(1, 2)  # (B, H, S, D) of (B, S, H, D)
    assert not view.is_contiguous()
    assert kernel.takes_regtile(view, view[:, :2], view[:, :2])
    off = torch.zeros(1 * 4 * 8 * 16 + 1)[1:].view(1, 4, 8, 16)
    assert off.data_ptr() % 16 != 0 and not kernel.takes_regtile(off, k, v)
    wide = torch.zeros(1, 2, 8, 18)[..., :16]  # row stride of 18 elements
    assert not kernel.takes_regtile(q, wide, wide)
    one = torch.zeros(1, 1, 1, 16)
    assert kernel.takes_regtile(one, one, one)
    assert kernel.takes_regtile(*_qkv(torch.float32, 16, 16, hq=ROWS, hkv=1, s=1))
    assert not kernel.takes_regtile(*_qkv(torch.float32, 16, 16, hq=2 * ROWS,
                                          hkv=1, s=1))
    assert ROWS == 128 and kernel.REGTILE_MAX_D == 128


def test_body_wrappers_refuse_cpu_tensors():
    q, k, v = _qkv(torch.float32, 16, 16)
    for fn in (kernel.flash_attention_simt_regtile,
               kernel.flash_attention_simt_basic):
        with pytest.raises(ValueError, match="CUDA"):
            fn(q, k, v, scale=0.25)
