"""Incremental index orchestration (from ``sema_tpu/index/manager.py``).

- per-file content hash checked against the stored manifest: unchanged →
  skip; changed → remove old chunks from BOTH indexes, then re-index;
  new → index;
- chunks go to both the vector and the text index; a failure in one is
  warned, not fatal, except a :class:`~sema_tpu_torch.ops._cuda.
  KernelError` (a kernel that does not build, launch or take its
  tensors), which propagates;
- the file hash is recorded only after its chunks are indexed, so a crash
  mid-index retries that file next run;
- once the store holds a live device copy (it has served a search), each
  slice's embeddings stay on the device too (``return_device``), and the
  store writes them into its tail's spare rows with no upload;
- with a ``mesh``, the store's rows shard over its ``index_axis`` (and
  ``slice_axis``, where the mesh has it); without one the store lies on
  the encoder's device;
- search dispatch: queries starting with ``'`` hit the BM25 text index
  (prefix stripped; empty rest → no results), everything else is
  semantic; a failed semantic query degrades to a substring scan with a
  warning, as the reference does, but a KernelError propagates: the
  fallback must not hide a broken kernel behind plausible answers.
"""

from __future__ import annotations

import os
import sys
from pathlib import Path
from typing import Callable, List, Optional, Sequence, Tuple

from sema_tpu_torch.index.text_index import make_text_index
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.ingest.chunker import process_files
from sema_tpu_torch.ingest.hashing import hash_file
from sema_tpu_torch.ops._cuda import KernelError
from sema_tpu_torch.types import Chunk
from sema_tpu_torch.utils.metrics import Metrics, null_metrics


class IndexManager:
    # indexing slice size: both indexes commit O(slice) at a time, so the
    # transient memory of their writes is one slice, not the corpus.
    # Override: SEMA_TPU_INDEX_BATCH.
    INDEX_BATCH = 65_536

    def __init__(self, data_dir: Path | str, encoder,
                 store_dtype: str = "bfloat16", mesh=None,
                 index_axis: str = "index", slice_axis: Optional[str] = None,
                 metrics: Optional[Metrics] = None, rescore_k: int = 100,
                 hbm_budget_mb: float = 0.0, ivf: bool = False,
                 ivf_nprobe: int = 32, ivf_min_recall: float = 0.0):
        self.encoder = encoder
        self.metrics = metrics or null_metrics()
        self.vector_store = VectorStore(
            data_dir, dim=encoder.spec.dim, model=encoder.spec.name,
            store_dtype=store_dtype, device=encoder.device, mesh=mesh,
            index_axis=index_axis, slice_axis=slice_axis,
            rescore_k=rescore_k, hbm_budget_mb=hbm_budget_mb, ivf=ivf,
            ivf_nprobe=ivf_nprobe, ivf_min_recall=ivf_min_recall)
        self.text_index = make_text_index(data_dir)

    # -- indexing ------------------------------------------------------------

    def process_and_index_files(
            self, files: Sequence[Path],
            progress: Optional[Callable[[str, int, int], None]] = None,
            purge_missing_under: Optional[Path] = None,
    ) -> int:
        """Index changed/new files; returns the number of chunks indexed.

        ``purge_missing_under``: also remove indexed files under that
        root which no longer exist on disk (scoped to the crawl root: the
        index is shared by every directory indexed)."""
        # (path, check-time hash): the hash recorded after indexing is the
        # one whose content was chunked
        files_to_process: List[tuple] = []
        with self.metrics.timer("hash_check"):
            for f in files:
                f = Path(f)
                if not f.exists():
                    continue
                try:
                    current = hash_file(f)
                except OSError:
                    continue
                stored = self.vector_store.get_file_hash(f)
                if stored == current:
                    continue
                if stored is not None:
                    self.vector_store.remove_file_chunks(f)
                    self.text_index.remove_file_chunks(f)
                files_to_process.append((f, current))

        purged = False
        if purge_missing_under is not None:
            sep = str(Path(purge_missing_under)).rstrip("/") + "/"
            for path in list(self.vector_store.file_hashes):
                if not path.startswith(sep) or Path(path).exists():
                    continue
                self.vector_store.remove_file_chunks(path)
                self.text_index.remove_file_chunks(path)
                self.vector_store.remove_file_hash(path)
                purged = True

        if progress:
            progress("chunking", 0, len(files_to_process))
        with self.metrics.timer("chunk"):
            chunks = process_files([f for f, _ in files_to_process])
        self.metrics.count("chunks", len(chunks))

        if chunks:
            self.index_chunks(chunks, progress=progress)
        if files_to_process or purged:
            # every processed file, including ones that yielded no chunk,
            # or they would re-detect as changed on every run
            with self.metrics.timer("hash_update"):
                for f, h in files_to_process:
                    self.vector_store.update_file_hash(f, h)
                self.vector_store.save_file_hashes()
        return len(chunks)

    def index_chunks(self, chunks: Sequence[Chunk], progress=None) -> None:
        """Dual-index chunks in bounded slices; failures are warnings,
        apart from a KernelError."""
        try:
            batch = int(os.environ.get("SEMA_TPU_INDEX_BATCH",
                                       self.INDEX_BATCH))
        except ValueError:
            batch = self.INDEX_BATCH
        if batch < 1:
            batch = self.INDEX_BATCH
        total = len(chunks)
        # an encoder-like object may not take return_device (a stub): ask
        # its signature once, not per slice
        try:
            import inspect
            has_return_device = "return_device" in inspect.signature(
                self.encoder.encode_texts).parameters
        except (TypeError, ValueError):
            has_return_device = False
        for off in range(0, total, batch):
            part = chunks[off:off + batch]
            try:
                with self.metrics.timer("embed"):
                    emb_progress = (
                        (lambda done, _t, off=off:
                         progress("embedding", off + done, total))
                        if progress else None)
                    # fetched at the store's dtype: the cast happens on
                    # the device and the copy back is narrower. With a
                    # live device copy the rows also stay on the device
                    # for the store's append; asked per slice, since the
                    # first search can land in the middle of a build
                    kw = ({"return_device":
                           self.vector_store.device_copy_live()}
                          if has_return_device else {})
                    embeddings = self.encoder.encode_texts(
                        [c.content for c in part], progress=emb_progress,
                        out_dtype=self.vector_store.torch_dtype, **kw)
                with self.metrics.timer("vector_write"):
                    self.vector_store.add_chunks(part, embeddings)
            except KernelError:
                raise
            except Exception as e:  # noqa: BLE001 — parity: warn, go on
                print("Warning: Failed to index chunks in vector "
                      f"store: {e}", file=sys.stderr)
            try:
                with self.metrics.timer("text_write"):
                    self.text_index.index_chunks(part)
            except Exception as e:  # noqa: BLE001
                print("Warning: Failed to index chunks in text "
                      f"index: {e}", file=sys.stderr)

    # -- search ----------------------------------------------------------------

    def search(self, query: str, limit: int,
               exact: bool = False) -> List[Tuple[Chunk, float]]:
        """Dispatch on the ``'`` prefix. ``exact=True`` makes the vector
        scan bypass IVF pruning for this query (recall@k 1.0 by
        construction); a no-op for text queries and stores without IVF."""
        query = query.strip()
        if query.startswith("'"):
            stripped = query[1:]
            if not stripped:
                return []
            with self.metrics.timer("text_search"):
                return self.text_index.search(stripped, limit)
        try:
            with self.metrics.timer("embed_query"):
                qvec = self.encoder.encode_query_device(query)
            with self.metrics.timer("vector_search"):
                return self.vector_store.search(qvec, limit, exact=exact)
        except KernelError:
            raise
        except Exception as e:  # noqa: BLE001 — parity: degrade, don't fail
            print(f"Warning: semantic query failed ({e}); falling back "
                  "to substring scan", file=sys.stderr)
            with self.metrics.timer("fallback_search"):
                return self.vector_store.substring_scan(query, limit)

    def close(self) -> None:
        self.text_index.close()
        self.vector_store.close()
