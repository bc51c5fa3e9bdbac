# Copy of sema_tpu/native/__init__.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Python bindings for the C++ native extension (libsema_native.so).

The native library implements the host-side hot loops that the reference
delegates to native Rust crates (SURVEY.md §2 native inventory):

- gitignore-aware directory crawl (≙ ``ignore`` crate, crawler/mod.rs),
- parallel byte-window chunker (≙ rayon + processor.rs),
- xxh3-128 content hashing (≙ xxhash-rust, storage/mod.rs:72-94).

Bindings use ctypes against a plain C ABI with length-prefixed binary
payloads (pybind11 is not available in this environment). Importing this
package raises ImportError when the library has not been built
(``make -C native``); callers fall back to the pure-Python implementations,
which are the semantic oracles the native code is tested against.
"""

from sema_tpu_torch.native.bindings import (
    chunk_files_native,
    crawl_native,
    hash_file_native,
    lib_path,
)

__all__ = ["chunk_files_native", "crawl_native", "hash_file_native", "lib_path"]
