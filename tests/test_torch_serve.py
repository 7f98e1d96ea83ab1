"""The port's serving launcher against ``repro.launch.serve``.

``ContinuousBatcher`` runs in lockstep with the reference's on the same
carried weights and prompts, under teacher forcing: after every admit
and every decode step the port's token history is overwritten with the
reference's, so each step's logits compare like with like.  The prefill
logits of every admitted request and the logits of every decode step
are held within atol 1e-4 (float32 smoke configs; see
``tests/test_torch_models.py``), and so are the caches at the end.  The
MoE configurations (``qwen3-moe-30b-a3b``, ``deepseek-v2-lite-16b``) and
the SSM ones (``mamba2-370m``, ``jamba-1.5-large-398b``: conv and SSM
states spliced per slot, with no sequence axis) run the same way, their
caches found by ``scan_grouping`` in the reference's tree (deepseek's
dense layer 0 is a prefix layer; mamba2's 2 layers are one group
stacked twice).  The CLI is run as ``tests/test_launchers.py`` runs the
reference's, for a dense, both MoE and both SSM configurations.
"""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax

from repro.launch import serve as jserve
from repro.models import transformer as JT
from repro_torch.configs.base import scan_grouping
from repro_torch.convert import model_params_from_numpy
from repro_torch.launch import serve
from repro_torch.models import model as M
from _torch_threads import one_thread  # noqa: F401 (autouse)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DENSE_ARCHS = ["internlm2-1.8b", "olmo-1b", "mistral-nemo-12b", "qwen1.5-110b"]
MOE_ARCHS = ["qwen3-moe-30b-a3b", "deepseek-v2-lite-16b"]
SSM_ARCHS = ["mamba2-370m", "jamba-1.5-large-398b"]
ATOL = 1e-4
REQUESTS, SLOTS, PROMPT, GEN, MAX = 3, 2, 8, 4, 32


def _capture_prefill(module, seen):
    orig = module.prefill

    def prefill(*args, **kw):
        logits, caches = orig(*args, **kw)
        seen.append(np.asarray(logits, dtype=np.float32)
                    if not isinstance(logits, torch.Tensor) else logits.numpy())
        return logits, caches

    return prefill


def jax_layer_cache(cfg, jcaches, L):
    """Layer L's cache dict from the reference's cache tree."""
    prefix, _, group = scan_grouping(cfg)
    if L < len(prefix):
        return jcaches[f"prefix{L}"]
    g, i = divmod(L - len(prefix), len(group))
    return {n: a[g] for n, a in jcaches["groups"][f"layer{i}"].items()}


@pytest.mark.parametrize("arch", DENSE_ARCHS + MOE_ARCHS + SSM_ARCHS)
def test_batcher_teacher_forced_logits_equal_reference(arch, monkeypatch):
    cfg = M.get_config(arch, smoke=True)
    jparams = JT.init_params(cfg, jax.random.key(0))
    params = model_params_from_numpy(
        cfg, jax.tree_util.tree_map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, cfg.vocab_size, size=PROMPT).astype(np.int32)
               for _ in range(REQUESTS)]

    j_pre, t_pre, j_dec, t_dec = [], [], [], []
    monkeypatch.setattr(jserve.T, "prefill", _capture_prefill(jserve.T, j_pre))
    monkeypatch.setattr(serve.T, "prefill", _capture_prefill(serve.T, t_pre))
    jb = jserve.ContinuousBatcher(cfg, jparams, SLOTS, MAX, "gspmd")
    tb = serve.ContinuousBatcher(cfg, params, SLOTS, MAX)
    j_decode, t_decode = jb._decode, tb._decode

    def j_capture(*args):
        out = j_decode(*args)
        j_dec.append(np.asarray(out[0]))
        return out

    def t_capture(*args):
        out = t_decode(*args)
        t_dec.append(out[0].numpy())
        return out

    jb._decode, tb._decode = j_capture, t_capture

    queue, finished = list(range(REQUESTS)), []
    while len(finished) < REQUESTS:
        while queue and jb.admit(queue[0], prompts[queue[0]]):
            rid = queue.pop(0)
            assert tb.admit(rid, prompts[rid])
            tb.outputs[rid] = list(jb.outputs[rid])
        jb.step()
        tb.step()
        for rid, toks in jb.outputs.items():
            tb.outputs[rid] = list(toks)
        done = jb.retire(GEN)
        assert tb.retire(GEN) == done
        np.testing.assert_array_equal(tb.pos, jb.pos)
        finished += done

    assert len(t_pre) == len(j_pre) == REQUESTS
    assert len(t_dec) == len(j_dec) > 0
    for got, want in zip(t_pre + t_dec, j_pre + j_dec):
        assert got.shape == want.shape
        np.testing.assert_allclose(got, want, atol=ATOL)
    for L, cache in enumerate(tb.caches):
        want_cache = jax_layer_cache(cfg, jb.caches, L)
        assert set(cache) == set(want_cache)
        for name, buf in cache.items():
            np.testing.assert_allclose(buf.numpy(), np.asarray(want_cache[name]),
                                       atol=ATOL)


def test_batcher_refuses_position_past_max_len():
    cfg = M.get_config("olmo-1b", smoke=True)
    from repro_torch.models import transformer as T

    params = T.init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    b = serve.ContinuousBatcher(cfg, params, slots=1, max_len=4)
    assert b.admit(0, np.arange(4, dtype=np.int32))
    assert not b.admit(1, np.arange(2, dtype=np.int32))  # no free slot
    with pytest.raises(ValueError, match="max_len"):
        b.step()


def run_cli(arch: str) -> None:
    env = dict(os.environ, PYTHONPATH=os.path.join(REPO, "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", arch,
         "--smoke", "--requests", "3", "--slots", "2", "--prompt-len", "8",
         "--gen-len", "4", "--max-len", "32", "--device", "cpu"],
        capture_output=True, text=True, env=env, timeout=300, cwd=REPO)
    assert out.returncode == 0, out.stdout[-800:] + out.stderr[-1500:]
    assert "finished request" in out.stdout
    assert "3 requests" in out.stdout


def test_serve_cli_on_cpu():
    """The reference's CLI test (``tests/test_launchers.py``), on the
    port with ``--device cpu``."""
    run_cli("olmo-1b")


@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_serve_cli_moe_on_cpu(arch):
    run_cli(arch)


@pytest.mark.parametrize("arch", SSM_ARCHS)
def test_serve_cli_ssm_on_cpu(arch):
    """mamba2 and jamba at the CLI's 8-token prompts (a chunk of 8)."""
    run_cli(arch)


def test_serve_default_device_raises_without_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        serve.main(["--arch", "olmo-1b", "--smoke", "--requests", "1"])


def test_serve_mesh_not_ported():
    """``--mesh host`` is ported: it builds a mesh over every visible
    card, so without one it raises (``--device cpu`` does not apply)."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="devices="):
        serve.main(["--arch", "olmo-1b", "--smoke", "--mesh", "host",
                    "--device", "cpu"])
