# Copy of sema_tpu/tokenizer/__init__.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Host-side tokenization for the BERT-family encoders."""

from sema_tpu_torch.tokenizer.wordpiece import (
    HashTokenizer,
    WordPieceTokenizer,
    load_tokenizer,
)

__all__ = ["WordPieceTokenizer", "HashTokenizer", "load_tokenizer"]
