"""The port's text conditioning against the JAX package, on the CPU.

  * the tokenizers: `ClipTokenizer` over a synthetic merges file (the repo
    holds no BPE merges; found through `$DIFFCODEC_CLIP_BPE`, as
    `default_tokenizer` looks for it) and `HashTokenizer` give the same ids
    in both packages;
  * `CLIPTextEncoder` at the tiny config and at full width (ViT-L/14's
    text tower: 12 layers of 768, 77 tokens, batch 2), fp32, on JAX's
    seeded parameters carried across by `load_clip_text_params`;
  * `DualFlowPipeline.encode_prompt` against JAX's.
"""

import gzip

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from diffcodec_tpu import config as jcfg
from diffcodec_tpu.models.clip_text import CLIPTextEncoder as JCLIP
from diffcodec_tpu.sampling.pipeline import DualFlowPipeline as JPipeline
from diffcodec_tpu.utils import tokenizer as jtok

from diffcodec_tpu_torch import config as tcfg
from diffcodec_tpu_torch import weights
from diffcodec_tpu_torch.models.clip_text import CLIPTextEncoder
from diffcodec_tpu_torch.sampling.pipeline import DualFlowPipeline
from diffcodec_tpu_torch.utils import tokenizer as ttok
from torch_threads import few_torch_threads

_few_torch_threads = few_torch_threads(1)

# fp32 through the encoder: matmuls, softmaxes and LayerNorm statistics sum
# in another order in XLA and in PyTorch's CPU kernels.  The output is a
# LayerNorm's (values up to ~5); the 12 full-width layers differ by ~5e-6
# at most, the tiny ones by ~2e-6: the JAX Pallas tests' fp32 tolerance
# holds both.
OP_TOL = dict(atol=2e-5, rtol=1e-4)

CAPTIONS = ["A man riding a horse on the beach.",
            "HELLO there, it's the WORLD's 2nd   test &amp; more!",
            "",
            "naïve café — unicode and a very long caption " * 6]


def _merges():
    """BPE merges learnt greedily from the captions' words: enough for
    multi-symbol tokens, tokens with </w> and characters left unmerged."""
    return [("t", "h"), ("th", "e</w>"), ("a", "n"), ("o", "r"),
            ("e", "r"), ("i", "n"), ("h", "e"), ("l", "l"), ("he", "ll"),
            ("o", "</w>"), ("hell", "o</w>"), ("c", "a"), ("a", "</w>"),
            ("in", "g</w>"), ("s", "</w>"), ("e", "</w>"), ("an", "d</w>"),
            ("m", "an</w>"), ("ri", "d"), ("r", "i"), ("t", "</w>")]


@pytest.fixture()
def merges_file(tmp_path, monkeypatch):
    path = tmp_path / "bpe_merges.txt.gz"
    with gzip.open(path, "wt", encoding="utf-8") as f:
        f.write("\n".join(["#version: 0.2"]
                          + [" ".join(m) for m in _merges()]))
    monkeypatch.setenv("DIFFCODEC_CLIP_BPE", str(path))
    return str(path)


def test_tokenizers_give_jax_ids(merges_file):
    assert ttok.bytes_to_unicode() == jtok.bytes_to_unicode()
    for L in (77, 12):
        want = jtok.default_tokenizer(L)
        got = ttok.default_tokenizer(L)
        assert isinstance(got, ttok.ClipTokenizer)
        ids = got(CAPTIONS)
        assert ids.dtype == np.int32 and ids.shape == (len(CAPTIONS), L)
        np.testing.assert_array_equal(ids, want(CAPTIONS))
        for text in CAPTIONS:
            assert got.encode_text(text) == want.encode_text(text)
    # merges were applied: "hello" is one token
    tok = ttok.ClipTokenizer.from_merges_file(merges_file, 8)
    assert tok.encode_text("hello") == [tok.encoder["hello</w>"]]
    assert ttok.ClipTokenizer.from_merges_file("/nonexistent") is None


def test_hash_tokenizer_gives_jax_ids(monkeypatch):
    monkeypatch.delenv("DIFFCODEC_CLIP_BPE", raising=False)
    got = ttok.default_tokenizer(77)
    assert isinstance(got, ttok.HashTokenizer)
    np.testing.assert_array_equal(got(CAPTIONS),
                                  jtok.default_tokenizer(77)(CAPTIONS))
    np.testing.assert_array_equal(
        ttok.HashTokenizer(1000, 9)(CAPTIONS),
        jtok.HashTokenizer(1000, 9)(CAPTIONS))


def _randomize(params, seed):
    """Seeded values for every leaf: LayerNorm scales near 1, small
    biases, kernels ~ N(0, 1/fan_in), embeddings ~ N(0, 0.5^2)."""
    rng = np.random.default_rng(seed)

    def leaf(path, p):
        name = str(getattr(path[-1], "key", path[-1]))
        if name == "scale":
            v = rng.uniform(0.7, 1.3, p.shape)
        elif name == "bias":
            v = rng.uniform(-0.1, 0.1, p.shape)
        elif name in ("embedding", "position_embedding"):
            v = rng.standard_normal(p.shape) * 0.5
        else:
            v = rng.standard_normal(p.shape) / np.sqrt(p.shape[0])
        return np.asarray(v, np.float32)

    return jax.tree_util.tree_map_with_path(leaf, params)


def _pair(tiny, seed):
    """(JAX module, its params, the port's encoder loaded from them)."""
    jc = jcfg.CLIPTextConfig.tiny() if tiny else jcfg.CLIPTextConfig()
    tc = tcfg.CLIPTextConfig.tiny() if tiny else tcfg.CLIPTextConfig()
    assert jc == jcfg.CLIPTextConfig(**tc.__dict__)
    jm = JCLIP(jc)
    params = _randomize(jax.eval_shape(
        jm.init, jax.random.PRNGKey(0),
        jnp.zeros((1, jc.max_length), jnp.int32)), seed)
    enc = CLIPTextEncoder(tc)
    weights.load_clip_text_params(enc, params)
    return jm, params, enc


@pytest.mark.parametrize("size", ["tiny", "full"])
def test_clip_text_encoder_matches_jax(size):
    jm, params, enc = _pair(size == "tiny", 1)
    L = enc.cfg.max_length
    ids = ttok.HashTokenizer(context_length=L)(CAPTIONS[:2])
    want = np.asarray(jax.jit(jm.apply)(params, jnp.asarray(ids)))
    with torch.no_grad():
        got = enc(torch.from_numpy(ids)).numpy()
    assert got.shape == (2, L, enc.cfg.hidden_dim)
    np.testing.assert_allclose(got, want, **OP_TOL)


def test_encode_prompt_matches_jax(merges_file):
    jm, params, enc = _pair(True, 2)
    L = enc.cfg.max_length
    prompts = CAPTIONS[:3]
    cases = [dict(), dict(negative_prompts="blurry, low quality"),
             dict(negative_prompts=["a", "b", "c"])]
    for kw in cases:
        want = JPipeline.encode_prompt(jm, params,
                                       jtok.default_tokenizer(L), prompts,
                                       **kw)
        got = DualFlowPipeline.encode_prompt(
            enc, ttok.default_tokenizer(L), prompts, **kw)
        for g, w in zip(got, want):
            assert isinstance(g, torch.Tensor) and not g.requires_grad
            np.testing.assert_allclose(g.numpy(), w, **OP_TOL)
    # a single prompt string and the default negative ""
    text, uncond = DualFlowPipeline.encode_prompt(
        enc, ttok.default_tokenizer(L), "hello")
    assert text.shape == uncond.shape == (1, L, enc.cfg.hidden_dim)
    with torch.no_grad():
        np.testing.assert_array_equal(
            uncond.numpy(),
            enc(torch.from_numpy(ttok.default_tokenizer(L)([""]))).numpy())
