# Copy of sema_tpu/ingest/__init__.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Host-side ingest: chunking and content hashing.

Hot host loops; backed by the C++ native extension when built
(``sema_tpu.native``), with byte-identical pure-Python fallbacks.
"""

from sema_tpu_torch.ingest.chunker import create_chunks, process_files
from sema_tpu_torch.ingest.hashing import hash_bytes, hash_file

__all__ = ["create_chunks", "process_files", "hash_bytes", "hash_file"]
