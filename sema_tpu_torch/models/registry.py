# Copy of sema_tpu/models/registry.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Encoder model registry.

The reference hardcodes one model — sentence-transformers/all-MiniLM-L6-v2,
384-d, max 256 tokens (embeddings.rs:7,95; lance_indexer.rs:43). We support
the BASELINE.json config ladder (BASELINE.md §targets): MiniLM-L6 (384-d),
bge-small-en (384-d), e5-base (768-d), gte-large (1024-d). All are BERT-family
encoders differing only in width/depth and pooling.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class EncoderSpec:
    name: str
    hf_repo: str
    vocab_size: int
    hidden_size: int
    num_layers: int
    num_heads: int
    intermediate_size: int
    max_position_embeddings: int
    dim: int                    # output embedding dim (== hidden for BERT)
    pooling: str                # "mean" (masked mean) or "cls"
    default_max_length: int = 256

    @property
    def head_dim(self) -> int:
        return self.hidden_size // self.num_heads


ENCODERS = {
    # The reference's model (embeddings.rs:95).
    "minilm-l6": EncoderSpec(
        name="minilm-l6",
        hf_repo="sentence-transformers/all-MiniLM-L6-v2",
        vocab_size=30522, hidden_size=384, num_layers=6, num_heads=12,
        intermediate_size=1536, max_position_embeddings=512,
        dim=384, pooling="mean"),
    "bge-small-en": EncoderSpec(
        name="bge-small-en",
        hf_repo="BAAI/bge-small-en-v1.5",
        vocab_size=30522, hidden_size=384, num_layers=12, num_heads=12,
        intermediate_size=1536, max_position_embeddings=512,
        dim=384, pooling="cls"),
    "e5-base": EncoderSpec(
        name="e5-base",
        hf_repo="intfloat/e5-base-v2",
        vocab_size=30522, hidden_size=768, num_layers=12, num_heads=12,
        intermediate_size=3072, max_position_embeddings=512,
        dim=768, pooling="mean"),
    "gte-large": EncoderSpec(
        name="gte-large",
        hf_repo="thenlper/gte-large",
        vocab_size=30522, hidden_size=1024, num_layers=24, num_heads=16,
        intermediate_size=4096, max_position_embeddings=512,
        dim=1024, pooling="mean"),
    # Tiny config for tests (not a published model).
    "test-tiny": EncoderSpec(
        name="test-tiny",
        hf_repo="",
        vocab_size=512, hidden_size=64, num_layers=2, num_heads=4,
        intermediate_size=128, max_position_embeddings=128,
        dim=64, pooling="mean", default_max_length=32),
}


def get_spec(name: str) -> EncoderSpec:
    try:
        return ENCODERS[name]
    except KeyError:
        raise KeyError(
            f"unknown encoder {name!r}; available: {sorted(ENCODERS)}") from None
