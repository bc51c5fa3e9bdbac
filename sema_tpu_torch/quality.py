# Copy of sema_tpu/quality.py with imports renamed and the port's skip reasons; tests/test_torch_imports.py checks it for drift.
"""Semantic quality gate: prove the encoder ranks meaningfully.

The reference's search quality comes entirely from the pretrained MiniLM it
downloads at startup (reference embeddings.rs:93-103); architectural parity
alone doesn't demonstrate it. This gate does, wherever real weights exist
(tools/fetch_weights.py):

1. **Retrieval check** — index a canned corpus of topic-distinct documents
   through the full pipeline (chunker → encoder → vector store) and assert
   each paraphrase query retrieves its expected document at rank 1. The
   queries share almost no keywords with their targets, so random or
   garbage embeddings fail this immediately (expected score with random
   weights: ~1/len(CORPUS) per query).
2. **Vector cross-check** (when ``tests/fixtures/quality_vectors_<model>.npz``
   exists, produced by ``tools/fetch_weights.py --make-fixtures``) — cosine
   between our JAX encoder's embeddings and the original HF torch model's
   must be >= 0.999 for every corpus doc and query.

Entry points: ``sema-tpu doctor`` (CLI), ``tests/test_quality_gate.py``
(pytest, auto-skips without weights), and :func:`run_quality_gate` (library).
"""

from __future__ import annotations

import tempfile
from dataclasses import dataclass, field
from pathlib import Path
from typing import List, Optional, Tuple

import numpy as np

# Canned corpus: distinct everyday topics, one short paragraph each.
# Queries are PARAPHRASES — minimal lexical overlap with their target doc —
# so BM25-ish accidental matches can't pass the gate.
CORPUS = {
    "passwords.md": (
        "If you forgot your password, click the reset link on the sign-in "
        "page. We will email you a secure link to choose new login "
        "credentials. Accounts lock after ten failed attempts."),
    "baking.md": (
        "Preheat the oven to 180 degrees. Cream the butter and sugar, fold "
        "in flour and eggs, then bake the sponge for twenty-five minutes "
        "until golden. Let the cake cool before icing."),
    "gpu_oom.md": (
        "CUDA out of memory errors usually mean the batch size is too "
        "large for the accelerator. Reduce it, enable gradient "
        "checkpointing, or use mixed precision to shrink activations."),
    "visas.md": (
        "Travelers entering the country for tourism need a valid passport "
        "and, depending on nationality, an entry permit obtained from the "
        "embassy before departure. Processing takes two weeks."),
    "compost.md": (
        "Layer green kitchen scraps with brown garden waste, keep the heap "
        "moist, and turn it monthly. In six months the organic matter "
        "breaks down into rich fertilizer for your vegetable beds."),
    "tcp.md": (
        "A TCP connection begins with a three-way handshake: SYN, SYN-ACK, "
        "ACK. Sequence numbers order the byte stream and retransmission "
        "timers recover lost segments."),
    "knee.md": (
        "Runners with pain on the outside of the knee often have iliotibial "
        "band syndrome. Rest, foam rolling, and strengthening the hip "
        "abductors usually resolve symptoms within weeks."),
    "mortgage.md": (
        "A fixed-rate home loan keeps the same interest for the whole "
        "term, while adjustable rates reset periodically. Lenders compare "
        "your debt-to-income ratio and credit score before approval."),
    "espresso.md": (
        "Grind the beans fine, tamp evenly with thirty pounds of pressure, "
        "and pull the shot for about twenty-seven seconds. Sour flavor "
        "means under-extraction; bitterness means over-extraction."),
    "aurora.md": (
        "The northern lights appear when charged particles from the sun "
        "collide with gases in the upper atmosphere. The best viewing is "
        "on clear winter nights far from city lights."),
    "sourdough.md": (
        "Feed the starter equal parts flour and water twice a day until it "
        "doubles within four hours. Bubbles and a tangy smell mean the "
        "wild yeast culture is active enough to leaven bread."),
    "regex.md": (
        "Use anchors to match the start and end of a line, character "
        "classes for sets, and non-greedy quantifiers when a pattern "
        "should stop at the first delimiter."),
}

# (paraphrase query, expected document)
QUERIES = [
    ("how do I recover my account when I can't log in", "passwords.md"),
    ("recipe steps for making a sponge cake", "baking.md"),
    ("my deep learning training crashes because VRAM is exhausted",
     "gpu_oom.md"),
    ("documents required to visit a foreign country", "visas.md"),
    ("turning food waste into garden fertilizer", "compost.md"),
    ("how network sockets establish a reliable session", "tcp.md"),
    ("lateral knee pain after jogging", "knee.md"),
    ("choosing between fixed and variable interest when buying a house",
     "mortgage.md"),
    ("why does my coffee shot taste sour", "espresso.md"),
    ("when can I see the aurora borealis", "aurora.md"),
    ("getting wild yeast ready to rise a loaf", "sourdough.md"),
    ("pattern matching that stops at the first comma", "regex.md"),
]

FIXTURE_COSINE_MIN = 0.999  # SURVEY.md §4 numerics gate


@dataclass
class QualityReport:
    ran: bool                   # False = skipped (no real weights)
    reason: str = ""
    total: int = 0
    correct_at_1: int = 0
    failures: List[Tuple[str, str, str]] = field(default_factory=list)
    # fixture cross-check (None = fixture not present)
    fixture_checked: Optional[int] = None
    fixture_min_cosine: Optional[float] = None

    @property
    def passed(self) -> bool:
        if not self.ran:
            return False
        if self.correct_at_1 != self.total:
            return False
        if self.fixture_min_cosine is not None and \
                self.fixture_min_cosine < FIXTURE_COSINE_MIN:
            return False
        return True


def _fixture_path(model_name: str) -> Path:
    return (Path(__file__).resolve().parents[1] / "tests" / "fixtures" /
            f"quality_vectors_{model_name}.npz")


def check_fixture_vectors(encoder, report: QualityReport) -> None:
    """Cosine cross-check against HF torch reference vectors, if present."""
    path = _fixture_path(encoder.spec.name)
    if not path.exists():
        return
    fx = np.load(path, allow_pickle=False)
    names = [str(n) for n in fx["doc_names"]]
    missing = [n for n in names if n not in CORPUS]
    if missing:
        # fixture generated against an older canned corpus: report a
        # failing cosine instead of crashing doctor with a KeyError
        report.fixture_checked = len(names)
        report.fixture_min_cosine = -1.0
        report.failures.append(
            ("<fixture>", "regenerate tests/fixtures (stale doc names: "
             + ", ".join(missing[:3]) + ")", "corpus changed"))
        return
    texts = [CORPUS[n] for n in names] + [str(q) for q in fx["query_texts"]]
    ref = np.concatenate([fx["doc_vectors"], fx["query_vectors"]], axis=0)
    ours = np.asarray(encoder.encode_texts(texts))
    cos = np.sum(ours * ref, axis=1) / (
        np.linalg.norm(ours, axis=1) * np.linalg.norm(ref, axis=1) + 1e-12)
    report.fixture_checked = len(texts)
    report.fixture_min_cosine = float(cos.min())


def run_quality_gate(encoder,
                     require_real_weights: bool = True) -> QualityReport:
    """Index the canned corpus end-to-end and assert rank-1 retrieval.

    ``encoder`` is a :class:`sema_tpu.models.Encoder` (or anything with the
    same ``spec``/``encode_texts``/``encode_query`` surface). Skips (does
    not fail) when the encoder runs on random-init weights OR a
    hash-fallback tokenizer — rankings are meaningless in both cases by
    construction, and a FAIL would point at the model when the problem
    is the missing tokenizer files.
    """
    from sema_tpu_torch.index.manager import IndexManager

    if require_real_weights and \
            getattr(encoder, "weights_source", "random") == "random":
        return QualityReport(
            ran=False,
            reason="encoder has random-init weights; put real weights in "
                   "a local dir (--weights DIR) or the HF cache to run "
                   "the quality gate")
    if require_real_weights and \
            getattr(encoder, "tokenizer_source", None) == "hash":
        return QualityReport(
            ran=False,
            reason="tokenizer fell back to hash buckets (no "
                   "tokenizer.json/vocab.txt found); real weights with a "
                   "hash tokenizer rank meaninglessly — put the "
                   "tokenizer files beside the weights (--weights DIR)")

    report = QualityReport(ran=True, total=len(QUERIES))
    with tempfile.TemporaryDirectory() as td:
        root = Path(td)
        corpus_dir = root / "corpus"
        corpus_dir.mkdir()
        for name, text in CORPUS.items():
            (corpus_dir / name).write_text(text)
        mgr = IndexManager(root / "data", encoder)
        try:
            mgr.process_and_index_files(sorted(corpus_dir.iterdir()))
            for query, expected in QUERIES:
                results = mgr.search(query, limit=3)
                got = results[0][0].file_path.name if results else "<none>"
                if got == expected:
                    report.correct_at_1 += 1
                else:
                    report.failures.append((query, expected, got))
        finally:
            mgr.close()

    check_fixture_vectors(encoder, report)
    return report
