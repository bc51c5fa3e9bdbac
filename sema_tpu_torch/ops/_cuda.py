"""Build and load the hand-written Hopper kernels in ``csrc/``.

Each ``csrc/<name>.cu`` is compiled by ``nvcc`` for ``sm_90a`` into its
own shared library with a plain C interface, at first use, and loaded
with ``ctypes``. The library name carries a hash of the source, of the
headers of ``csrc/`` (``hopper.cuh``, which both sources include) and of
the flags, so an edited source or header is rebuilt and an unchanged one
is reused.
``build()`` starts one ``nvcc`` per missing source, all at once.
``defines`` (``-D`` macros) build a source a second time into a library
of its own; only the attribution tools of ``sema_tpu_torch/tools/`` pass
them, so no product path loads such a build.

The build directory (``build/kernels/`` at the repository root) is listed
in ``.gitignore``. Nothing here runs at import time: a host without
``nvcc`` or a card imports this module and only fails when a CUDA tensor
asks for a kernel.

Every failure of a kernel on the card raises :class:`KernelError`: a
missing ``nvcc``, a failed build, a CUDA error returned by an entry point,
and a wrapper's refusal of a CUDA tensor it does not take. The index,
query and serving paths let it through where they degrade on any other
error, so a kernel that does not build or launch never hides behind the
substring fallback. A CPU tensor never raises it: it takes the plain
version.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
import time
from pathlib import Path
from typing import Dict, Iterable, Optional, Tuple

CSRC = Path(__file__).resolve().parents[1] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "kernels"
SOURCES = ("scan_topk", "encoder_layer")
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_libs: Dict[tuple, ctypes.CDLL] = {}     # (name, defines) → library
_bound: set = set()          # ((name, defines), entry point) bound
_ready: Dict[tuple, ctypes.CDLL] = {}    # (name, defines, id(signatures))
_lock = threading.Lock()


class KernelError(RuntimeError):
    """A kernel of ``csrc/`` did not build, did not launch, or refused the
    CUDA tensors it was given."""


def _nvcc() -> str:
    home = os.environ.get("CUDA_HOME") or "/usr/local/cuda"
    for cand in (shutil.which("nvcc"), os.path.join(home, "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise KernelError("nvcc not found (looked on PATH and in "
                       f"{home}/bin); the CUDA kernels cannot be built")


def _macros(defines: Tuple[str, ...]) -> Tuple[str, ...]:
    return tuple(f"-D{d}" for d in defines)


def lib_path(name: str, defines: Tuple[str, ...] = ()) -> Path:
    """Where ``csrc/<name>.cu`` builds to: keyed by source, the headers of
    ``csrc/`` it may include, and flags (and the ``defines`` of a second
    build, which its name also shows)."""
    h = hashlib.sha1((CSRC / f"{name}.cu").read_bytes())
    for header in sorted(CSRC.glob("*.cuh")):
        h.update(header.read_bytes())
    h.update(" ".join(NVCC_FLAGS + _macros(defines)).encode())
    tag = "".join("-" + re.sub(r"\W", "", d) for d in defines)
    return BUILD_DIR / f"lib{name}{tag}-{h.hexdigest()[:12]}.so"


def build(names: Optional[Iterable[str]] = None,
          defines: Tuple[str, ...] = ()) -> Dict[str, float]:
    """Compile every missing library of ``names`` (default: all), one
    ``nvcc`` process per source, all started together, each with the
    macros ``defines`` (``"NAME=VALUE"``). Returns the seconds each build
    took (0.0 when the library was already there). Raises KernelError
    with the compiler's output if one fails."""
    names = tuple(SOURCES if names is None else names)
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = None
    running = {}
    seconds = {}
    for name in names:
        out = lib_path(name, defines)
        if out.exists():
            seconds[name] = 0.0
            continue
        nvcc = nvcc or _nvcc()
        tmp = out.with_name(f"{out.name}.tmp{os.getpid()}")
        log = open(out.with_suffix(".log"), "w")
        proc = subprocess.Popen(
            [nvcc, *NVCC_FLAGS, *_macros(defines), "-o", str(tmp),
             str(CSRC / f"{name}.cu")],
            stdout=log, stderr=subprocess.STDOUT)
        running[name] = (proc, tmp, out, log, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, log, t0) in running.items():
        rc = proc.wait()
        log.close()
        seconds[name] = time.perf_counter() - t0
        if rc == 0:
            os.replace(tmp, out)
        else:
            failed.append(f"{name} (nvcc rc={rc}):\n"
                          + out.with_suffix(".log").read_text())
    if failed:
        raise KernelError("kernel build failed: " + "\n".join(failed))
    return seconds


def library(name: str, signatures: Dict[str, list],
            defines: Tuple[str, ...] = ()) -> ctypes.CDLL:
    """The loaded library of ``csrc/<name>.cu`` (built with ``defines``),
    built first if needed. ``signatures`` maps each C entry point to its
    ctypes argtypes (two modules may bind entry points of one library);
    every entry point returns a ``cudaError_t`` as int. Once a module's
    ``signatures`` are bound, its later calls take one dict lookup."""
    lib = _ready.get((name, tuple(defines), id(signatures)))
    if lib is not None:
        return lib
    key = (name, tuple(defines))
    with _lock:
        lib = _libs.get(key)
        if lib is None:
            build([name], key[1])
            path = lib_path(name, key[1])
            try:
                lib = ctypes.CDLL(str(path))
            except OSError as e:
                raise KernelError(f"cannot load {path}: {e}") from e
            lib.sema_cuda_error_string.argtypes = [ctypes.c_int]
            lib.sema_cuda_error_string.restype = ctypes.c_char_p
            _libs[key] = lib
        for fn, argtypes in signatures.items():
            if (key, fn) not in _bound:
                f = getattr(lib, fn)
                f.argtypes = argtypes
                f.restype = ctypes.c_int
                _bound.add((key, fn))
        # the signatures dict lives as long as its module, so its id does
        _ready[(name, key[1], id(signatures))] = lib
        return lib


def check(lib: ctypes.CDLL, err: int, what: str) -> None:
    """Raise if a kernel entry point reported a CUDA error."""
    if err != 0:
        msg = lib.sema_cuda_error_string(err).decode()
        raise KernelError(f"{what}: CUDA error {err} ({msg})")


def aligned(t):
    """``t`` contiguous and 16-byte aligned (the kernels load 16 bytes at
    a time): ``t`` itself when it already is, else a copy."""
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def _stream(card: int) -> int:
    """The handle of ``card``'s current stream (0: the legacy default
    stream, whichever card is current)."""
    import torch
    return torch._C._cuda_getCurrentRawStream(card)


def launch(entry, device, *args) -> int:
    """``entry(*args, stream, card)``, a kernel entry point called with the
    current stream of ``device``'s card while that card is the current
    one: a kernel launches on the current card, and a mesh's shards may
    lie on several cards. ``torch.cuda.device`` is entered only when
    another card is current; the entry point itself refuses a card that
    is not current, or a stream of another card
    (``csrc/*.cu:on_card``). Returns the entry point's ``cudaError_t``."""
    import torch
    current = torch.cuda.current_device()
    card = current if device.index is None else device.index
    if card == current:
        return entry(*args, _stream(card), card)
    with torch.cuda.device(card):
        return entry(*args, _stream(card), card)
