"""The modality stubs and the training data pipeline against the
reference at smoke size.

``internvl2-26b`` (``vision_stub``: patch embeddings through
``patch_proj``, put before the text) and ``musicgen-large``
(``audio_stub``: frame embeddings in, ``num_codebooks`` heads out, logits
(B, S, C, V)): parameters from the reference's ``init_params`` carried
by ``convert.model_params_from_numpy``, the same seeded inputs through
both packages.  ``forward``, ``prefill`` and one ``decode_step`` are held
within atol 1e-4 (``tests/test_models.py``'s bound on decode against
forward; the packages differ in summation order only) and a relative RMS
of 1e-5, as ``tests/test_torch_models.py`` holds the text models;
``lm_loss`` within 1e-6 relative.  Mirrors
``tests/test_models.py::test_decode_matches_forward`` for both stubs and
``tests/test_pipeline.py::TestTokenPipeline`` on the port, whose
batches equal the reference's bit for bit.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from repro.data.pipeline import TokenPipeline as JPipeline
from repro.models import model as JM
from repro.models import transformer as JT
from repro_torch.convert import model_params_from_numpy
from repro_torch.data.pipeline import TokenPipeline
from repro_torch.launch.serve import ContinuousBatcher
from repro_torch.models import model as M
from repro_torch.models import transformer as T

STUBS = ["internvl2-26b", "musicgen-large"]
ATOL = 1e-4
LOGIT_RTOL = 1e-5
B, S, MAX = 2, 16, 32


def rel_rms(got, want) -> float:
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.sqrt(((got - want) ** 2).mean() / (want ** 2).mean()))


def assert_logits(got: torch.Tensor, want) -> None:
    np.testing.assert_allclose(got.detach().numpy(), np.asarray(want), atol=ATOL)
    assert rel_rms(got.detach().numpy(), want) <= LOGIT_RTOL


@pytest.fixture(scope="module", params=STUBS)
def stub(request):
    cfg = M.get_config(request.param, smoke=True)
    jparams = JT.init_params(cfg, jax.random.key(0))
    tree = jax.tree_util.tree_map(np.asarray, jparams)
    return cfg, jparams, model_params_from_numpy(cfg, tree, device="cpu")


def inputs(cfg, s, seed, patches=True) -> dict:
    """A numpy batch: frames for the audio stub; tokens (after P patches
    when ``patches``) for the vision stub."""
    rng = np.random.default_rng(seed)
    if cfg.modality == "audio_stub":
        return {"frame_embeds": rng.normal(size=(B, s, cfg.d_model))
                .astype(np.float32)}
    P = cfg.num_patches if patches else 0
    out = {"tokens": rng.integers(0, cfg.vocab_size, size=(B, s - P))
           .astype(np.int32)}
    if patches:
        out["patch_embeds"] = rng.normal(size=(B, P, cfg.d_model)).astype(np.float32)
    return out


def both(batch):
    return ({k: jnp.asarray(v) for k, v in batch.items()},
            {k: torch.from_numpy(v) for k, v in batch.items()})


def test_stub_layouts(stub):
    cfg, _, params = stub
    names = dict(params.named_parameters())
    V, D = cfg.padded_vocab_size, cfg.d_model
    if cfg.modality == "audio_stub":
        assert "lm_head.w" not in names and "patch_proj.w" not in names
        for c in range(cfg.num_codebooks):
            assert names[f"head{c}.w"].shape == (D, V)
    else:
        assert "head0.w" not in names
        assert names["patch_proj.w"].shape == (D, D)
        assert names["lm_head.w"].shape == (D, V)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("arch", STUBS)
def test_stub_param_counts_equal_reference(arch, smoke):
    cfg = M.get_config(arch, smoke=smoke)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(
        JM.get_config(arch, smoke=smoke))


def test_full_width_counts():
    """The sizes the card trains: musicgen-large whole (3.24 B) and
    internvl2-26b at full width cut to its first 8 of 48 layers (4.30 B;
    all 48 are 19.9 B)."""
    assert M.count_params_analytic(M.get_config("musicgen-large")) == 3_242_395_648
    vl = M.get_config("internvl2-26b")
    assert M.count_params_analytic(vl) == 19_900_471_296
    assert M.count_params_analytic(vl.with_overrides(num_layers=8)) == 4_297_168_896


def test_forward_equals_jax(stub):
    cfg, jparams, params = stub
    jb, tb = both(inputs(cfg, S, seed=1))
    want, _ = JT.forward(cfg, jparams, jb)
    got, aux = T.forward(cfg, params, tb)
    shape = (B, S, cfg.num_codebooks, cfg.padded_vocab_size) \
        if cfg.num_codebooks else (B, S, cfg.padded_vocab_size)
    assert got.shape == tuple(np.shape(want)) == shape
    assert_logits(got, want)
    assert float(aux) == 0.0


def test_vision_stub_without_patches_equals_jax():
    """A text-only batch: no patch projection, the text model's logits."""
    cfg = M.get_config("internvl2-26b", smoke=True)
    jparams = JT.init_params(cfg, jax.random.key(1))
    params = model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    jb, tb = both(inputs(cfg, S, seed=6, patches=False))
    want, _ = JT.forward(cfg, jparams, jb)
    got, _ = T.forward(cfg, params, tb)
    assert got.shape == (B, S, cfg.padded_vocab_size)
    assert_logits(got, want)


def test_prefill_and_decode_step_equal_jax(stub):
    cfg, jparams, params = stub
    jb, tb = both(inputs(cfg, S, seed=2))
    jl, jc = JT.prefill(cfg, jparams, jb, max_len=MAX)
    tl, tc = T.prefill(cfg, params, tb, max_len=MAX)
    assert_logits(tl, jl)
    rng = np.random.default_rng(3)
    if cfg.modality == "audio_stub":
        nxt = rng.normal(size=(B, 1, cfg.d_model)).astype(np.float32)
    else:
        nxt = rng.integers(0, cfg.vocab_size, size=(B, 1)).astype(np.int32)
    jl2, jc2 = JT.decode_step(cfg, jparams, jc, jnp.asarray(nxt), jnp.int32(S))
    tl2, _ = T.decode_step(cfg, params, tc, torch.from_numpy(nxt), S)
    assert tl2.shape == tuple(np.shape(jl2))
    assert_logits(tl2, jl2)


def test_decode_matches_forward(stub):
    """The port alone (``tests/test_models.py::test_decode_matches_forward``):
    prefill + two decode steps == forward over the prompt and the two
    inputs."""
    cfg, _, params = stub
    full = inputs(cfg, S + 2, seed=4)
    tb = {k: torch.from_numpy(v) for k, v in full.items()}
    key = "frame_embeds" if cfg.modality == "audio_stub" else "tokens"
    prompt = dict(tb, **{key: tb[key][:, :-2]})
    logits_pre, caches = T.prefill(cfg, params, prompt, max_len=MAX)
    want, _ = T.forward(cfg, params, tb)
    np.testing.assert_allclose(logits_pre[:, 0].numpy(),
                               want[:, S - 1].numpy(), atol=ATOL)
    for i in range(2):
        step_in = tb[key][:, -2 + i:][:, :1]
        logits, caches = T.decode_step(cfg, params, caches, step_in, S + i)
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   want[:, S + i].numpy(), atol=ATOL)


@pytest.mark.parametrize("codebooks, masked", [(False, False), (False, True),
                                               (True, True)])
def test_lm_loss_equals_jax(codebooks, masked):
    cfg = M.get_config("musicgen-large" if codebooks else "olmo-1b", smoke=True)
    rng = np.random.default_rng(5)
    shape = (B, S, cfg.num_codebooks) if codebooks else (B, S)
    logits = (rng.normal(size=shape + (cfg.padded_vocab_size,)) * 3).astype(np.float32)
    labels = rng.integers(0, cfg.vocab_size, size=shape).astype(np.int32)
    mask = (rng.random(shape) < 0.7).astype(np.float32) if masked else None
    want = JT.lm_loss(cfg, jnp.asarray(logits), jnp.asarray(labels),
                      None if mask is None else jnp.asarray(mask))
    got = T.lm_loss(cfg, torch.from_numpy(logits), torch.from_numpy(labels),
                    None if mask is None else torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == ()
    assert float(got) == pytest.approx(float(want), rel=1e-6)
    # An all-zero mask divides by 1, as the reference's maximum(sum, 1).
    zero = T.lm_loss(cfg, torch.from_numpy(logits), torch.from_numpy(labels),
                     torch.zeros(shape))
    assert float(zero) == 0.0


def test_vision_stub_served_as_text_audio_refused():
    """The batcher serves the vision stub's text prompts, as the
    reference does; the audio stub takes frame embeddings, which the
    batcher does not, and raises."""
    cfg = M.get_config("internvl2-26b", smoke=True)
    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    batcher = ContinuousBatcher(cfg, params, slots=2, max_len=32)
    assert batcher.admit(0, np.arange(8, dtype=np.int32))
    batcher.step()
    assert len(batcher.outputs[0]) == 2
    audio = M.get_config("musicgen-large", smoke=True)
    aparams = T.init_params(audio, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(NotImplementedError, match="frame embeddings"):
        ContinuousBatcher(audio, aparams, slots=2, max_len=32)


# ---------------------------------------------------------------------------
# TokenPipeline
# ---------------------------------------------------------------------------

def _assert_tree_equal(a, b):
    assert a.keys() == b.keys()
    for k in a:
        if isinstance(a[k], dict):
            _assert_tree_equal(a[k], b[k])
        else:
            assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("arch, batch, seq, hosts", [
    ("olmo-1b", 4, 32, 1), ("internlm2-1.8b", 8, 16, 2),
    ("internvl2-26b", 2, 32, 1), ("internvl2-26b", 4, 24, 2),
    ("musicgen-large", 2, 16, 1), ("musicgen-large", 4, 8, 2)])
def test_batches_equal_reference_bit_for_bit(arch, batch, seq, hosts):
    cfg = M.get_config(arch, smoke=True)
    for host in range(hosts):
        mine = TokenPipeline(cfg, batch=batch, seq=seq, seed=11,
                             num_hosts=hosts, host_id=host)
        theirs = JPipeline(cfg, batch=batch, seq=seq, seed=11,
                           num_hosts=hosts, host_id=host)
        for _ in range(3):
            _assert_tree_equal(mine.next_batch(), theirs.next_batch())
        assert mine.state_dict() == theirs.state_dict()


def test_full_width_vision_batch_shapes():
    """The card's internvl2 batch: S = 2048 of which 256 patches."""
    cfg = M.get_config("internvl2-26b")
    b = TokenPipeline(cfg, batch=1, seq=512, seed=0).next_batch()
    assert b["batch"]["patch_embeds"].shape == (1, 256, cfg.d_model)
    assert b["batch"]["tokens"].shape == (1, 256)
    assert b["labels"].shape == b["loss_mask"].shape == (1, 512)
    assert b["batch"]["tokens"].max() < cfg.vocab_size


class TestTokenPipeline:
    """``tests/test_pipeline.py::TestTokenPipeline`` on the port."""

    def test_deterministic_and_resumable(self):
        cfg = M.get_config("olmo-1b", smoke=True)
        a = TokenPipeline(cfg, batch=4, seq=32, seed=7)
        b = TokenPipeline(cfg, batch=4, seq=32, seed=7)
        for _ in range(3):
            np.testing.assert_array_equal(a.next_batch()["batch"]["tokens"],
                                          b.next_batch()["batch"]["tokens"])
        c = TokenPipeline(cfg, batch=4, seq=32, seed=7)
        c.load_state_dict(a.state_dict())
        np.testing.assert_array_equal(a.next_batch()["batch"]["tokens"],
                                      c.next_batch()["batch"]["tokens"])

    def test_host_shards_disjoint_and_cover(self):
        cfg = M.get_config("olmo-1b", smoke=True)
        full = TokenPipeline(cfg, batch=8, seq=16, seed=1)
        h0 = TokenPipeline(cfg, batch=8, seq=16, seed=1, num_hosts=2, host_id=0)
        h1 = TokenPipeline(cfg, batch=8, seq=16, seed=1, num_hosts=2, host_id=1)
        f = full.next_batch()["batch"]["tokens"]
        t0 = h0.next_batch()["batch"]["tokens"]
        t1 = h1.next_batch()["batch"]["tokens"]
        np.testing.assert_array_equal(np.concatenate([t0, t1]), f)

    def test_labels_are_shifted_inputs(self):
        cfg = M.get_config("olmo-1b", smoke=True)
        b = TokenPipeline(cfg, batch=2, seq=16, seed=0).next_batch()
        toks, labels = b["batch"]["tokens"], b["labels"]
        assert np.mean(labels == (5 * toks + 1) % (cfg.vocab_size - 1)) > 0.7

    def test_vlm_masks_patches(self):
        cfg = M.get_config("internvl2-26b", smoke=True)
        b = TokenPipeline(cfg, batch=2, seq=32, seed=0).next_batch()
        P = cfg.num_patches
        assert b["batch"]["patch_embeds"].shape == (2, P, cfg.d_model)
        assert b["batch"]["tokens"].shape == (2, 32 - P)
        assert np.all(b["loss_mask"][:, :P] == 0)
        assert np.all(b["loss_mask"][:, P:] == 1)
        assert b["labels"].shape == (2, 32)

    def test_audio_codebooks(self):
        cfg = M.get_config("musicgen-large", smoke=True)
        b = TokenPipeline(cfg, batch=2, seq=16, seed=0).next_batch()
        assert b["batch"]["frame_embeds"].shape == (2, 16, cfg.d_model)
        assert b["labels"].shape == (2, 16, cfg.num_codebooks)
