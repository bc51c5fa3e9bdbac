# Copy of sema_tpu/tokenizer/wordpiece.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""BERT WordPiece tokenization (uncased).

The reference tokenizes with the HF ``tokenizers`` Rust crate using
MiniLM's tokenizer.json (embeddings.rs:20,27-33), then hard-truncates the
encoded ids to MAX_LENGTH with zero-padding (embeddings.rs:35-46 — note the
truncation simply drops tokens past the limit; the final token need not be
[SEP]). We reproduce those exact semantics.

Implementation:

- :class:`WordPieceTokenizer` — a from-scratch implementation of BERT
  uncased tokenization: text cleaning, CJK isolation, lowercasing + accent
  stripping (NFD), punctuation splitting, then greedy longest-match-first
  WordPiece with ``##`` continuations. Matches HF's BertWordPieceTokenizer
  output token-for-token (verified in tests against the installed
  ``tokenizers`` package over a shared vocab).
- :class:`HashTokenizer` — offline fallback when no vocab file exists
  (zero-egress environments): words map to stable hash buckets over the
  model's vocab range. Not WordPiece, but deterministic and collision-sparse;
  keeps the full pipeline and benchmarks runnable.

Vocab resolution mirrors weight resolution (models/loader.py): explicit path
→ HF cache → fallback.
"""

from __future__ import annotations

import hashlib
import json
import os
import unicodedata
from pathlib import Path
from typing import Dict, List, Optional, Tuple

PAD, UNK, CLS, SEP, MASK = "[PAD]", "[UNK]", "[CLS]", "[SEP]", "[MASK]"


def _is_whitespace(ch: str) -> bool:
    if ch in (" ", "\t", "\n", "\r"):
        return True
    return unicodedata.category(ch) == "Zs"


def _is_control(ch: str) -> bool:
    if ch in ("\t", "\n", "\r"):
        return False
    return unicodedata.category(ch).startswith("C")


def _is_punctuation(ch: str) -> bool:
    cp = ord(ch)
    # ASCII ranges BERT treats as punctuation even where unicodedata doesn't
    if (33 <= cp <= 47) or (58 <= cp <= 64) or (91 <= cp <= 96) or (123 <= cp <= 126):
        return True
    return unicodedata.category(ch).startswith("P")


def _is_cjk(cp: int) -> bool:
    return (
        0x4E00 <= cp <= 0x9FFF or 0x3400 <= cp <= 0x4DBF
        or 0x20000 <= cp <= 0x2A6DF or 0x2A700 <= cp <= 0x2B73F
        or 0x2B740 <= cp <= 0x2B81F or 0x2B820 <= cp <= 0x2CEAF
        or 0xF900 <= cp <= 0xFAFF or 0x2F800 <= cp <= 0x2FA1F)


def _build_ascii_table(lowercase: bool) -> Dict[int, Optional[str]]:
    """str.translate table implementing basic_tokenize for pure-ASCII
    text in one C-speed pass: \\t/\\n/\\r → space, other C0 controls and
    DEL deleted, punctuation isolated with surrounding spaces (so
    ``.split()`` yields it as its own token — equivalent to the slow
    path's per-token punctuation split), uppercase lowered. ASCII has no
    CJK, no Zs beyond space, and is NFD-invariant, so the fast path is
    semantics-identical (asserted differentially in test_tokenizer)."""
    table: Dict[int, Optional[str]] = {}
    for cp in range(128):
        ch = chr(cp)
        if ch in "\t\n\r":
            table[cp] = " "
        elif cp < 32 or cp == 127:
            table[cp] = None
        elif _is_punctuation(ch):
            table[cp] = f" {ch} "
        elif lowercase and "A" <= ch <= "Z":
            table[cp] = ch.lower()
    return table


_ASCII_TABLES = {True: _build_ascii_table(True),
                 False: _build_ascii_table(False)}


def basic_tokenize(text: str, lowercase: bool = True) -> List[str]:
    """BERT BasicTokenizer: clean, CJK-isolate, lowercase+strip accents,
    split punctuation, split whitespace.

    Pure-ASCII input (the overwhelming case for code corpora) takes a
    single translate+split pass — ~20× the per-char loop, measured on
    the 1-core dev box where host tokenization gated the e2e index
    build (docs/PERF.md)."""
    if text.isascii():
        return text.translate(_ASCII_TABLES[lowercase]).split()
    return _basic_tokenize_slow(text, lowercase)


def _basic_tokenize_slow(text: str, lowercase: bool = True) -> List[str]:
    """Per-character reference path (any unicode); the differential
    oracle for the ASCII fast lane in test_tokenizer."""
    cleaned = []
    for ch in text:
        cp = ord(ch)
        if cp == 0 or cp == 0xFFFD or _is_control(ch):
            continue
        if _is_whitespace(ch):
            cleaned.append(" ")
        elif _is_cjk(cp):
            cleaned.extend((" ", ch, " "))
        else:
            cleaned.append(ch)
    tokens = "".join(cleaned).split()

    out: List[str] = []
    for token in tokens:
        if lowercase:
            token = token.lower()
            token = "".join(c for c in unicodedata.normalize("NFD", token)
                            if unicodedata.category(c) != "Mn")
        # split on punctuation
        current: List[str] = []
        for ch in token:
            if _is_punctuation(ch):
                if current:
                    out.append("".join(current))
                    current = []
                out.append(ch)
            else:
                current.append(ch)
        if current:
            out.append("".join(current))
    return out


class WordPieceTokenizer:
    """Greedy longest-match-first WordPiece over a BERT vocab."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True,
                 max_word_chars: int = 100):
        self.vocab = vocab
        self.lowercase = lowercase
        self.max_word_chars = max_word_chars
        self.pad_id = vocab.get(PAD, 0)
        self.unk_id = vocab.get(UNK, 1)
        self.cls_id = vocab.get(CLS, 2)
        self.sep_id = vocab.get(SEP, 3)
        # word→pieces memo: corpora repeat words heavily, and the greedy
        # longest-match loop is the pure-Python path's hot spot
        self._piece_cache: Dict[str, List[str]] = {}

    @classmethod
    def from_vocab_file(cls, path: Path | str, **kw) -> "WordPieceTokenizer":
        vocab = {}
        with open(path, encoding="utf-8") as f:
            for i, line in enumerate(f):
                vocab[line.rstrip("\n")] = i
        return cls(vocab, **kw)

    @classmethod
    def from_tokenizer_json(cls, path: Path | str) -> "WordPieceTokenizer":
        data = json.loads(Path(path).read_text(encoding="utf-8"))
        vocab = data["model"]["vocab"]
        lowercase = True
        norm = data.get("normalizer") or {}
        if norm.get("type") == "BertNormalizer":
            lowercase = norm.get("lowercase", True)
        return cls(vocab, lowercase=lowercase)

    def wordpiece(self, word: str) -> List[str]:
        cached = self._piece_cache.get(word)
        if cached is not None:
            return cached
        pieces = self._wordpiece_uncached(word)
        if len(self._piece_cache) >= 1_000_000:   # bound host RSS
            self._piece_cache.clear()
        self._piece_cache[word] = pieces
        return pieces

    def _wordpiece_uncached(self, word: str) -> List[str]:
        if len(word) > self.max_word_chars:
            return [UNK]
        pieces: List[str] = []
        start = 0
        n = len(word)
        while start < n:
            end = n
            piece = None
            while start < end:
                sub = word[start:end]
                if start > 0:
                    sub = "##" + sub
                if sub in self.vocab:
                    piece = sub
                    break
                end -= 1
            if piece is None:
                return [UNK]
            pieces.append(piece)
            start = end
        return pieces

    def tokenize(self, text: str) -> List[str]:
        out: List[str] = []
        for word in basic_tokenize(text, self.lowercase):
            out.extend(self.wordpiece(word))
        return out

    def encode(self, text: str, max_length: int) -> Tuple[List[int], List[int]]:
        """ids + attention mask, specials added then hard-truncated to
        ``max_length`` (parity with embeddings.rs:40-46)."""
        ids = [self.cls_id]
        ids += [self.vocab.get(t, self.unk_id) for t in self.tokenize(text)]
        ids.append(self.sep_id)
        ids = ids[:max_length]
        mask = [1] * len(ids)
        return ids, mask


class HashTokenizer:
    """Vocab-free fallback: stable hash buckets over the model vocab range.

    Used only when neither an explicit vocab nor an HF cache entry exists.
    Reserves ids 0-4 for specials, buckets words into [5, vocab_size).
    """

    def __init__(self, vocab_size: int, lowercase: bool = True):
        self.vocab_size = vocab_size
        self.lowercase = lowercase
        self.pad_id, self.unk_id, self.cls_id, self.sep_id = 0, 1, 2, 3
        self._reserved = 5
        # word→bucket memo (words repeat heavily; blake2s is cheap but
        # not free at millions of words on the 1-core dev box)
        self._bucket_cache: Dict[str, int] = {}

    def _bucket(self, word: str) -> int:
        b = self._bucket_cache.get(word)
        if b is None:
            h = int.from_bytes(
                hashlib.blake2s(word.encode("utf-8"),
                                digest_size=8).digest(), "big")
            b = self._reserved + h % (self.vocab_size - self._reserved)
            if len(self._bucket_cache) >= 1_000_000:   # bound host RSS
                self._bucket_cache.clear()
            self._bucket_cache[word] = b
        return b

    def tokenize(self, text: str) -> List[str]:
        return basic_tokenize(text, self.lowercase)

    def encode(self, text: str, max_length: int) -> Tuple[List[int], List[int]]:
        ids = [self.cls_id]
        ids += [self._bucket(w) for w in self.tokenize(text)]
        ids.append(self.sep_id)
        ids = ids[:max_length]
        return ids, [1] * len(ids)


class HFTokenizerBackend:
    """Production tokenizer: the ``tokenizers`` Rust core (the same library
    the reference links, embeddings.rs:20) wrapped with our encode
    semantics. Used automatically when a vocab is available;
    ``SEMA_TPU_PURE_TOKENIZER=1`` forces the pure-Python implementation
    (which is the parity oracle in tests)."""

    def __init__(self, vocab: Dict[str, int], lowercase: bool = True):
        from tokenizers import Tokenizer, models, normalizers, pre_tokenizers

        self._tok = Tokenizer(models.WordPiece(
            vocab, unk_token=UNK, max_input_chars_per_word=100))
        self._tok.normalizer = normalizers.BertNormalizer(lowercase=lowercase)
        self._tok.pre_tokenizer = pre_tokenizers.BertPreTokenizer()
        self.vocab = vocab
        self.pad_id = vocab.get(PAD, 0)
        self.unk_id = vocab.get(UNK, 1)
        self.cls_id = vocab.get(CLS, 2)
        self.sep_id = vocab.get(SEP, 3)

    def _finish(self, ids: List[int], max_length: int):
        ids = [self.cls_id] + ids + [self.sep_id]
        ids = ids[:max_length]
        return ids, [1] * len(ids)

    def encode(self, text: str, max_length: int):
        return self._finish(self._tok.encode(text).ids, max_length)

    def encode_batch(self, texts: List[str], max_length: int):
        encs = self._tok.encode_batch(texts)
        return [self._finish(e.ids, max_length) for e in encs]


def _wrap_vocab(vocab: Dict[str, int], lowercase: bool = True):
    """Pick the fast Rust backend when available, else pure Python."""
    if os.environ.get("SEMA_TPU_PURE_TOKENIZER"):
        return WordPieceTokenizer(vocab, lowercase=lowercase)
    try:
        return HFTokenizerBackend(vocab, lowercase=lowercase)
    except Exception:  # noqa: BLE001 — an installed-but-incompatible
        # `tokenizers` (constructor signature drift → TypeError, vocab
        # rejection → ValueError) must fall back exactly like a missing
        # one: the pure-Python backend is a drop-in (review finding, r3)
        return WordPieceTokenizer(vocab, lowercase=lowercase)


# single copy of the HF-cache snapshot resolution (was duplicated here
# and in models/loader.py; review finding, r3)
from sema_tpu_torch.utils.hfcache import hf_cache_snapshot as _hf_cache_snapshot  # noqa: E402,E501


def load_tokenizer(vocab_size: int, hf_repo: str = "",
                   path: str = ""):
    """Resolve a tokenizer: explicit path → HF cache → hash fallback.

    Returns (tokenizer, source) with source ∈ {"local", "hf-cache", "hash"}.
    A ``path`` that carries only WEIGHTS (dir without tokenizer files,
    or the safetensors file itself — both valid for models/loader.py)
    falls through to the cache/hash chain instead of crashing on a
    binary 'vocab' parse (review finding, r3).
    """
    if path:
        p = Path(path)
        if p.is_dir():
            for name in ("tokenizer.json", "vocab.txt"):
                if (p / name).exists():
                    p = p / name
                    break
        if p.name == "tokenizer.json":
            ref = WordPieceTokenizer.from_tokenizer_json(p)
            return _wrap_vocab(ref.vocab, ref.lowercase), "local"
        if p.is_file() and p.suffix not in (".safetensors", ".bin", ".pt",
                                            ".onnx"):
            ref = WordPieceTokenizer.from_vocab_file(p)
            return _wrap_vocab(ref.vocab, ref.lowercase), "local"
        # a weights-only path: resolve the tokenizer from the cache/hash
        # chain below rather than failing the whole Encoder construction

    if hf_repo:
        snap = _hf_cache_snapshot(hf_repo)
        if snap is not None:
            for name in ("tokenizer.json", "vocab.txt"):
                if (snap / name).exists():
                    loader = (WordPieceTokenizer.from_tokenizer_json
                              if name == "tokenizer.json"
                              else WordPieceTokenizer.from_vocab_file)
                    ref = loader(snap / name)
                    return _wrap_vocab(ref.vocab, ref.lowercase), "hf-cache"

    return HashTokenizer(vocab_size), "hash"
