"""sema_tpu_torch — the PyTorch/CUDA port of sema_tpu.

The same semantic + keyword search over local files, with the device side
written in PyTorch and the two kernels of the index → query path written
by hand for NVIDIA Hopper (``csrc/``):

- host side: crawl, chunk, hash, tokenize, BM25 text index, config, CLI —
  headed copies of the ``sema_tpu`` host modules;
- device side: the BERT-family encoder forward (every layer through the
  encoder-layer kernel) and a single-device exact vector store (every
  bucket scanned by the top-k scan kernel).

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``;
on a CPU tensor each kernel wrapper runs its plain PyTorch version.
"""

__version__ = "0.1.0"
