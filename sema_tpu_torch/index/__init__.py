"""Index layer of the port: the exact vector store on one device, the
BM25 text index, and the incremental index manager over both."""

from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.index.text_index import TextIndex
from sema_tpu_torch.index.manager import IndexManager

__all__ = ["VectorStore", "TextIndex", "IndexManager"]
