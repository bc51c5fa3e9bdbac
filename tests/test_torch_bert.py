"""The port's encoder forward and ``Encoder`` held against the JAX package's
on the same weights: ``sema_tpu``'s random params carried across with
``params_from_jax``, the same numpy token ids, f32 compute on the CPU."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from sema_tpu.models import bert as jax_bert
from sema_tpu.models.encoder import Encoder as JaxEncoder
from sema_tpu.models.loader import random_params
from sema_tpu.models.registry import get_spec as jax_spec
from sema_tpu.tokenizer import HashTokenizer as JaxHashTokenizer
from sema_tpu_torch.models import bert
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import params_from_jax
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.tokenizer import HashTokenizer


def _specs(max_pos=None):
    js, ps = jax_spec("test-tiny"), get_spec("test-tiny")
    if max_pos is not None:
        js = dataclasses.replace(js, max_position_embeddings=max_pos)
        ps = dataclasses.replace(ps, max_position_embeddings=max_pos)
    return js, ps


def _ids(b, s, vocab, seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(5, vocab, size=(b, s)).astype(np.int32)
    lengths = rng.integers(1, s + 1, size=b)
    lengths[0] = s
    mask = (np.arange(s)[None, :] < lengths[:, None]).astype(np.int32)
    return np.where(mask > 0, ids, 0).astype(np.int32), mask


def _cosine_rows(a, b):
    return (a * b).sum(-1) / (np.linalg.norm(a, axis=-1)
                              * np.linalg.norm(b, axis=-1))


@pytest.mark.parametrize("b,s,max_pos", [
    (2, 16, None),      # within the position table
    (2, 24, 16),        # longer than the table: rows past it repeat row 15
])
def test_embed_matches_jax_fused_f32(b, s, max_pos):
    js, ps = _specs(max_pos)
    jparams = random_params(js)
    ids, mask = _ids(b, s, js.vocab_size, seed=s)
    want = np.asarray(jax_bert.embed(jparams, jnp.asarray(ids),
                                     jnp.asarray(mask), js,
                                     compute_dtype=jnp.float32,
                                     attn_impl="fused"))
    got = bert.embed(params_from_jax(jparams), torch.from_numpy(ids),
                     torch.from_numpy(mask), ps,
                     compute_dtype=torch.float32).numpy()
    assert got.shape == (b, ps.dim) and got.dtype == np.float32
    # f32 throughout; two layers of sums taken in another order
    np.testing.assert_allclose(got, want, atol=2e-5, rtol=0)
    assert _cosine_rows(got, want).min() >= 0.99999


def test_embed_tokens_clamps_positions_past_the_table():
    _, ps = _specs(max_pos=8)
    params = params_from_jax(random_params(_specs(max_pos=8)[0]))
    emb = params["embeddings"]
    ids = torch.full((1, 12), 7, dtype=torch.int32)
    x = bert._embed_tokens(emb, ids, torch.float32)
    # identical tokens at positions 7..11 all read position row 7
    for p in range(8, 12):
        torch.testing.assert_close(x[0, p], x[0, 7], rtol=0, atol=0)


TEXTS = [
    "def parse_expression(tokens): return build_tree(tokens)",
    "retry logic with exponential backoff " * 9,       # past 32 tokens
    "x",
    "",
    "class VectorStore:\n    '''exact top-k over bf16 rows'''\n" * 2,
]


def test_encode_texts_matches_jax_encoder_f32():
    js, ps = _specs()
    jparams = random_params(js)
    jenc = JaxEncoder(js, jparams, JaxHashTokenizer(js.vocab_size),
                      max_length=64, batch_size=2,
                      compute_dtype=jnp.float32)
    penc = Encoder(ps, params_from_jax(jparams),
                   HashTokenizer(ps.vocab_size), max_length=64,
                   batch_size=2, compute_dtype=torch.float32, device="cpu")
    want = jenc.encode_texts(TEXTS)
    got = penc.encode_texts(TEXTS)
    assert got.shape == (len(TEXTS), ps.dim) and got.dtype == torch.float32
    # f32 throughout; the 32- and 64-token buckets both run
    np.testing.assert_allclose(got.numpy(), want, atol=2e-5, rtol=0)
    # the query path pads to max_length and agrees with the batch path
    q_want = jenc.encode_query(TEXTS[0])
    q_got = penc.encode_query(TEXTS[0])
    np.testing.assert_allclose(q_got, q_want, atol=2e-5, rtol=0)
    np.testing.assert_allclose(q_got, got[0].numpy(), atol=2e-5, rtol=0)


def test_encode_texts_store_dtype_and_progress():
    _, ps = _specs()
    penc = Encoder(ps, params_from_jax(random_params(_specs()[0])),
                   HashTokenizer(ps.vocab_size), max_length=64,
                   batch_size=2, compute_dtype=torch.float32, device="cpu")
    seen = []
    out = penc.encode_texts(TEXTS, progress=lambda d, t: seen.append((d, t)),
                            out_dtype=torch.bfloat16)
    assert out.dtype == torch.bfloat16 and out.shape == (len(TEXTS), ps.dim)
    assert seen[-1] == (len(TEXTS), len(TEXTS))
    assert all(d < t for d, t in seen[:-1])
    f32 = penc.encode_texts(TEXTS)
    torch.testing.assert_close(out, f32.to(torch.bfloat16), rtol=0, atol=0)
    assert penc.encode_texts([]).shape == (0, ps.dim)


def _hf_tensors(tree, spec):
    """``tree`` (the JAX package's params) under Hugging Face BERT names."""
    from sema_tpu_torch.models import loader
    h = spec.hidden_size
    flat = {"bert." + hf: tree["embeddings"][ours]
            for ours, hf in loader._EMB_LEAVES}
    for i in range(spec.num_layers):
        pre = f"bert.encoder.layer.{i}."
        for ours, suffix, transpose in loader._LAYER_LEAVES:
            w = tree["layers"][ours][i]
            flat[pre + suffix] = w.T if transpose else w
        for j, part in enumerate(("query", "key", "value")):
            cols = slice(j * h, (j + 1) * h)
            flat[f"{pre}attention.self.{part}.weight"] = \
                tree["layers"]["qkv_w"][i][:, cols].T
            flat[f"{pre}attention.self.{part}.bias"] = \
                tree["layers"]["qkv_b"][i][cols]
    return {k: np.ascontiguousarray(v) for k, v in flat.items()}


def test_load_params_reads_the_safetensors_jax_reads(tmp_path):
    from safetensors.numpy import save_file
    from sema_tpu.models.loader import load_params as jax_load_params
    from sema_tpu_torch.models.loader import load_params
    js, ps = _specs()
    tree = {g: {k: np.asarray(v) for k, v in leaves.items()}
            for g, leaves in random_params(js, seed=3).items()}
    save_file(_hf_tensors(tree, js), str(tmp_path / "model.safetensors"))
    want, want_source = jax_load_params(js, str(tmp_path))
    got, source = load_params(ps, str(tmp_path))
    assert source == want_source == "local"
    for group, leaves in want.items():
        assert set(got[group]) == set(leaves)
        for name, leaf in leaves.items():
            np.testing.assert_array_equal(got[group][name].numpy(),
                                          np.asarray(leaf))
    # the HF names above are the inverse of the loaders' mapping
    np.testing.assert_array_equal(got["layers"]["qkv_w"].numpy(),
                                  tree["layers"]["qkv_w"])


def test_read_safetensors_matches_the_library(tmp_path):
    from safetensors.torch import load_file, save_file
    from sema_tpu_torch.models.loader import read_safetensors
    g = torch.Generator().manual_seed(0)
    tensors = {"a.bf16": torch.randn(3, 5, generator=g).bfloat16(),
               "b.f16": torch.randn(7, generator=g).half(),
               "c.f32": torch.randn(2, 2, 2, generator=g),
               "d.i64": torch.arange(6).reshape(2, 3)}
    save_file(tensors, str(tmp_path / "m.safetensors"),
              metadata={"format": "pt"})
    got = read_safetensors(tmp_path / "m.safetensors")
    want = load_file(str(tmp_path / "m.safetensors"))
    assert set(got) == set(want)
    for name, t in want.items():
        expect = t.float() if t.dtype == torch.bfloat16 else t
        np.testing.assert_array_equal(got[name], expect.numpy())
    assert got["a.bf16"].dtype == np.float32


def test_cast_params_rounds_as_each_forward_would():
    js, ps = _specs()
    params = params_from_jax(random_params(js))
    cast = bert.cast_params(params, torch.bfloat16)
    assert cast["layers"]["qkv_w"].dtype == torch.bfloat16
    assert cast["embeddings"]["word"].dtype == torch.bfloat16
    assert cast["layers"]["attn_ln_scale"].dtype == torch.float32
    assert cast["embeddings"]["position"].dtype == torch.float32
    ids, mask = (torch.from_numpy(a) for a in _ids(2, 16, ps.vocab_size, 5))
    want = bert.embed(params, ids, mask, ps, torch.bfloat16)
    got = bert.embed(cast, ids, mask, ps, torch.bfloat16)
    torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.float16])
def test_encoder_on_the_card_takes_bf16_only(monkeypatch, dtype):
    """The card's encoder takes every compute dtype of the JAX package's
    Encoder (K2 has bf16, f16 and f32 routes)."""
    from sema_tpu_torch.models import encoder as encoder_mod
    monkeypatch.setattr(encoder_mod, "resolve_device",
                        lambda device: torch.device("cuda"))
    monkeypatch.setattr(encoder_mod.bert, "cast_params",
                        lambda params, compute_dtype: params)
    enc = Encoder(get_spec("test-tiny"), {}, HashTokenizer(64),
                  compute_dtype=dtype, device="cuda")
    assert enc.device.type == "cuda" and enc.compute_dtype == dtype
