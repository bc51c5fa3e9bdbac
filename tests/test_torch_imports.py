"""The port stands alone: it imports neither ``jax`` nor ``sema_tpu``, its
headed copies of ``sema_tpu``'s host modules have not drifted from their
sources, and a request for the card never continues on the CPU."""

import json
import os
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from sema_tpu_torch import cli, device
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import random_params
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.ops import _cuda
from sema_tpu_torch.tokenizer import HashTokenizer

REPO = Path(__file__).resolve().parents[1]

# A blocked jax, every module of the port imported, then the CLI's index
# and query on the CPU with the default model (MiniLM-L6, random weights),
# the tensor-parallel encoder on a (2, 2) mesh of CPU shards, and a store
# row-sharded over a (slice 2, index 2) mesh of CPU shards.
_ISOLATED = r"""
import importlib, io, json, pkgutil, sys
from contextlib import redirect_stdout
sys.modules["jax"] = None
import sema_tpu_torch
names = [m.name for m in pkgutil.walk_packages(sema_tpu_torch.__path__,
                                               "sema_tpu_torch.")]
for name in names:
    try:
        importlib.import_module(name)
    except ImportError as e:    # the optional C++ library, when unbuilt
        if "libsema_native.so" not in str(e):
            raise
from sema_tpu_torch import cli
out = io.StringIO()
with redirect_stdout(out):
    assert cli.main(["index", sys.argv[1], "--device", "cpu"]) == 0
    assert cli.main(["query", "exponential backoff", "--json",
                     "--device", "cpu"]) == 0
hits = [json.loads(l) for l in out.getvalue().splitlines()
        if l.startswith("{")]
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import random_params
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.parallel.mesh import make_mesh
from sema_tpu_torch.tokenizer import HashTokenizer
spec = get_spec("test-tiny")
tp = Encoder(spec, random_params(spec), HashTokenizer(spec.vocab_size),
             mesh=make_mesh([2, 2], ("data", "model"), devices=["cpu"] * 4),
             model_axis="model")
import tempfile
import numpy as np
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.types import Chunk
rows = np.random.default_rng(0).standard_normal((300, 64)).astype(np.float32)
rows /= np.linalg.norm(rows, axis=1, keepdims=True)
with tempfile.TemporaryDirectory() as td:
    store = VectorStore(td, 64, "m", device="cpu", slice_axis="slice",
                        mesh=make_mesh([2, 2], ("slice", "index"),
                                       devices=["cpu"] * 4))
    store.add_chunks([Chunk(f"r{i}", "f.py", 1, 1, "") for i in range(300)],
                     rows)
    sharded = [c.id for c, _ in store.search(rows[211], 3)]
    store.close()
print(json.dumps({
    "modules": names, "hits": len(hits), "sharded": sharded,
    "tp_rows": tuple(tp.encode_texts(["a", "b", "c"]).shape),
    "sema_tpu": sorted(m for m in sys.modules
                       if m == "sema_tpu" or m.startswith("sema_tpu.")),
    "jax": sorted(m for m in sys.modules
                  if (m == "jax" or m.startswith("jax."))
                  and sys.modules[m] is not None)}))
"""


def test_port_runs_with_jax_blocked_and_imports_no_sema_tpu(tmp_path):
    tree = tmp_path / "tree"
    tree.mkdir()
    (tree / "net.md").write_text(
        "# HTTP networking\nRetry logic with exponential backoff.\n" * 8)
    (tree / "parse.py").write_text("def parse(tokens):\n    return tokens\n")
    env = dict(os.environ, SEMA_TPU_HOME=str(tmp_path / "home"),
               SEMA_TPU_DATA=str(tmp_path / "data"))
    proc = subprocess.run([sys.executable, "-c", _ISOLATED, str(tree)],
                          cwd=REPO, env=env, capture_output=True, text=True,
                          timeout=300)
    assert proc.returncode == 0, proc.stderr[-3000:]
    report = json.loads(proc.stdout.splitlines()[-1])
    assert "sema_tpu_torch.ops.scan_topk" in report["modules"]
    assert "sema_tpu_torch.cli" in report["modules"]
    for name in ("parallel", "parallel.mesh", "parallel.sharded_topk",
                 "parallel.multislice", "models.tp", "ops.attention",
                 "tools", "tools.scan_ab15", "tools.scan_ab14",
                 "tools.tui_monkey", "tools.load_test",
                 "tools.spill_ivf_bench", "tools.query_breakdown",
                 "tools.ivf_bench", "tools.serving_sweep",
                 "tools.index_build_bench", "tools.text_index_scale",
                 "tools.encoder_ablate", "tui", "tui.app", "tui.events",
                 "tui.render", "selftest", "quality"):
        assert f"sema_tpu_torch.{name}" in report["modules"]
    assert report["hits"] > 0 and report["tp_rows"] == [3, 64]
    assert report["sharded"][0] == "r211"
    assert report["sema_tpu"] == [] and report["jax"] == []


def test_no_import_of_jax_or_sema_tpu_in_the_port_source():
    pattern = re.compile(r"^\s*(import|from)\s+(jax|sema_tpu)\b", re.M)
    files = sorted((REPO / "sema_tpu_torch").rglob("*.py"))
    files += [REPO / "chip_smoke.py", REPO / "chip_merge_ab.py"]
    offenders = [str(f) for f in files if pattern.search(f.read_text())]
    assert len(files) > 30 and offenders == []


# Headed copies of sema_tpu host modules: identical to their source once
# ``sema_tpu`` is renamed in import lines, apart from the header line and
# the replacements listed here (each must match its source exactly once).
COPIES = """types.py config.py utils/__init__.py utils/fsio.py utils/metrics.py
utils/hfcache.py crawl/__init__.py crawl/gitignore.py crawl/crawler.py
ingest/__init__.py ingest/chunker.py ingest/hashing.py native/__init__.py
native/bindings.py tokenizer/__init__.py tokenizer/wordpiece.py
models/registry.py index/text_segment.py index/text_index.py index/ivf_cache.py
search/__init__.py search/engine.py search/server.py
search/http_server.py tui/__init__.py tui/events.py tui/render.py tui/app.py
quality.py tools/tui_monkey.py tools/text_index_scale.py""".split()

# A copy's source, where it is not sema_tpu/<the same path>.
SOURCES = {"tools/tui_monkey.py": "tools/tui_monkey.py",
           "tools/text_index_scale.py": "tools/text_index_scale.py"}

_XXHASH_OPTIONAL = '''import hashlib
from pathlib import Path

try:
    import xxhash
except ImportError:
    # blake2b-128 instead; the "b2:" prefix keeps these digests from ever
    # matching an xxh3 manifest written by a host that has xxhash
    xxhash = None

HASH_NAME = "xxh3-128" if xxhash is not None else "blake2b-128"
'''

REPLACEMENTS = {
    # a KernelError leaves the search: the TUI ends non-zero with the
    # kernel's message instead of showing "Search failed"
    "search/engine.py": [
        ("from sema_tpu_torch.types import AppState, SearchResult, UIMode\n",
         "from sema_tpu_torch.ops._cuda import KernelError\n"
         "from sema_tpu_torch.types import AppState, SearchResult, UIMode\n"),
        ("            raw = self.index_manager.search(query, limit)\n"
         "        except Exception as e:",
         "            raw = self.index_manager.search(query, limit)\n"
         "        except KernelError:\n"
         "            raise   # a kernel that does not build or launch is a "
         "fault,\n"
         "            #         never a failed search\n"
         "        except Exception as e:"),
    ],
    # the port's device, and a KernelError of the crawl, the index or the
    # warm-up leaves the app instead of becoming "Indexing failed"
    "tui/app.py": [
        ("from sema_tpu_torch.search.engine import Engine\n",
         "from sema_tpu_torch.ops._cuda import KernelError\n"
         "from sema_tpu_torch.search.engine import Engine\n"),
        ("    def __init__(self, directory: Path, config):\n"
         "        self.directory = directory\n"
         "        self.config = config\n",
         "    def __init__(self, directory: Path, config, device: str = "
         "\"cuda\"):\n"
         "        self.directory = directory\n"
         "        self.config = config\n"
         "        self.device = device\n"),
        ("            mgr = make_index_manager(self.config)\n",
         "            mgr = make_index_manager(self.config, self.device)\n"),
        ('                    mgr.search("warmup", 1)\n'
         "            except Exception:",
         '                    mgr.search("warmup", 1)\n'
         "            except KernelError:\n"
         "                raise\n"
         "            except Exception:"),
        ("        except TuiApp._QuitDuringIndex:\n            raise\n",
         "        except (TuiApp._QuitDuringIndex, KernelError):\n"
         "            raise\n"),
        ("def run_app(directory: Path, config) -> int:\n"
         "    app = TuiApp(directory, config)\n",
         "def run_app(directory: Path, config, device: str = \"cuda\") -> int:\n"
         "    app = TuiApp(directory, config, device)\n"),
    ],
    # the port fetches nothing (models/loader.py): its skip reasons say
    # where local weights go; its encoder returns a torch tensor
    "quality.py": [
        ("    ours = encoder.encode_texts(texts)\n",
         "    ours = np.asarray(encoder.encode_texts(texts))\n"),
        ('"encoder has random-init weights; fetch real weights "\n'
         '                   "with tools/fetch_weights.py to run the quality '
         'gate")',
         '"encoder has random-init weights; put real weights in "\n'
         '                   "a local dir (--weights DIR) or the HF cache to '
         'run "\n'
         '                   "the quality gate")'),
        ('hash tokenizer rank meaninglessly — fetch the "\n'
         '                   "tokenizer files (tools/fetch_weights.py)")',
         'hash tokenizer rank meaninglessly — put the "\n'
         '                   "tokenizer files beside the weights (--weights '
         'DIR)")'),
    ],
    "tools/tui_monkey.py": [
        ('[sys.executable, "-m", "sema_tpu.cli", "tui",',
         '[sys.executable, "-m", "sema_tpu_torch", "tui",'),
    ],
    # run as a module of the port; its last line names where it ran and
    # the kernels it launched (none: the text index is host only)
    "tools/text_index_scale.py": [
        ("    python tools/text_index_scale.py --docs 2000000 [--batch 4096]\n",
         "    python -m sema_tpu_torch.tools.text_index_scale --docs 2000000 "
         "[--batch 4096]\n"),
        ("sys.path.insert(0, str(Path(__file__).resolve().parents[1]))\n",
         "sys.path.insert(0, str(Path(__file__).resolve().parents[2]))\n"),
        ('        "commit_ms_p50_last16": round(\n'
         '            statistics.median(late) * 1e3, 1),\n',
         '        "commit_ms_p50_last16": round(\n'
         '            statistics.median(late) * 1e3, 1),\n'
         '        "device": "cpu",\n'
         '        "launches": {},\n'),
    ],
    # a KernelError is surfaced, never degraded to the substring scan or
    # swallowed by the warm-up
    "search/http_server.py": [
        ("from sema_tpu_torch.search.server import QueryBatcher, "
         "ServerOverloaded\n",
         "from sema_tpu_torch.ops._cuda import KernelError\n"
         "from sema_tpu_torch.search.server import QueryBatcher, "
         "ServerOverloaded\n"),
        ("        except (ServerOverloaded, TimeoutError):\n"
         "            raise   # shed load",
         "        except KernelError:\n"
         "            raise   # a kernel that does not build or launch is a "
         "fault to\n"
         "            #         surface (500), never a query to degrade\n"
         "        except (ServerOverloaded, TimeoutError):\n"
         "            raise   # shed load"),
        ('            service.search("warmup", 1)\n        except Exception:',
         '            service.search("warmup", 1)\n'
         "        except KernelError:\n"
         "            # kernels that do not build or launch: take no traffic\n"
         "            service.close()\n"
         "            server.server_close()\n"
         "            raise\n"
         "        except Exception:"),
    ],
    "ingest/hashing.py": [
        ("from pathlib import Path\n\nimport xxhash\n", _XXHASH_OPTIONAL),
        ('hex."""\n    return format(',
         'hex."""\n    if xxhash is None:\n        return "b2:" + '
         'hashlib.blake2b(data, digest_size=16).hexdigest()\n'
         '    return format('),
        ("    h = xxhash.xxh3_128()\n",
         "    if xxhash is None:\n        h = hashlib.blake2b(digest_size=16)"
         "\n    else:\n        h = xxhash.xxh3_128()\n"),
        ('            h.update(block)\n    return',
         '            h.update(block)\n    if xxhash is None:\n'
         '        return "b2:" + h.hexdigest()\n    return'),
    ],
    # a bf16 blob is held as its uint16 bit patterns (no ml_dtypes) and
    # named "bfloat16" in the header, so that either package reads the
    # other's spilled-bucket blobs
    "index/ivf_cache.py": [
        ('        "vectors_dtype": (str(np.dtype(vectors.dtype))',
         '        "vectors_dtype": (_dtype_name(vectors.dtype)'),
        ('    if name == "bfloat16":\n        import ml_dtypes\n'
         '        return ml_dtypes.bfloat16\n    return np.dtype(name)\n',
         '    if name == "bfloat16":\n'
         '        # the port holds bf16 rows as their uint16 bit patterns\n'
         '        return np.uint16\n    return np.dtype(name)\n\n\n'
         'def _dtype_name(dtype) -> str:\n'
         '    """A blob\'s dtype as the header names it: the port\'s uint16 bit\n'
         '    patterns are bf16 rows, named as the JAX package names its own."""\n'
         '    dtype = np.dtype(dtype)\n'
         '    return "bfloat16" if dtype == np.uint16 else str(dtype)\n'),
    ],
    "utils/metrics.py": [
        ("``jax.profiler`` trace", "``torch.profiler`` trace"),
        ("a jax.profiler trace (view in XProf/Perfetto)",
         "a torch.profiler trace (view in Perfetto/chrome://tracing)"),
        ("    import jax\n", "    import torch\n"),
        ("    jax.profiler.start_trace(log_dir)\n",
         "    acts = [torch.profiler.ProfilerActivity.CPU]\n"
         "    if torch.cuda.is_available():\n"
         "        acts.append(torch.profiler.ProfilerActivity.CUDA)\n"
         "    prof = torch.profiler.profile(activities=acts)\n"
         "    prof.start()\n"),
        ("        jax.profiler.stop_trace()\n",
         "        prof.stop()\n"
         "        os.makedirs(log_dir, exist_ok=True)\n"
         "        prof.export_chrome_trace(os.path.join(log_dir, "
         "\"trace.json\"))\n"),
    ],
}


# Paths in a source's prose that the copy words otherwise: the machine's
# the source was written on, a notes file's (pattern, replacement; one
# match each).
PATTERN_REPLACEMENTS = {
    "index/text_segment.py": [(r"\(/\w+/reference/src/",
                               "(the reference's src/")],
    "tools/tui_monkey.py": [(r"`\.\w+/skills/verify`'s", "the verify skill's")],
}


@pytest.mark.parametrize("rel", COPIES)
def test_copy_has_not_drifted(rel):
    source_rel = SOURCES.get(rel, f"sema_tpu/{rel}")
    source = (REPO / source_rel).read_text()
    header, copy = (REPO / "sema_tpu_torch" / rel).read_text().split("\n", 1)
    assert header.startswith(f"# Copy of {source_rel} ")
    want = re.sub(r"^(\s*)(from|import) sema_tpu\b", r"\1\2 sema_tpu_torch",
                  source, flags=re.M)
    for old, new in REPLACEMENTS.get(rel, ()):
        assert want.count(old) == 1, old
        want = want.replace(old, new)
    for pattern, new in PATTERN_REPLACEMENTS.get(rel, ()):
        want, n = re.subn(pattern, lambda m: new, want)
        assert n == 1, pattern
    assert copy == want


def test_only_the_tools_load_an_ablated_kernel_build():
    """A ``defines`` build of a kernel source (``_cuda.build``/``library``
    with ``-D`` macros: the attribution builds of encoder_ablate) is
    asked for under ``tools/`` only; no product module can load one."""
    call = re.compile(r"\b(_cuda\.)?(build|library)\((?:[^()]|\([^()]*\))*"
                      r"\bdefines\b", re.S)
    users = sorted(str(f.relative_to(REPO / "sema_tpu_torch"))
                   for f in (REPO / "sema_tpu_torch").rglob("*.py")
                   if f.name != "_cuda.py" and call.search(f.read_text()))
    assert users == ["tools/encoder_ablate.py"]
    assert "SEMA_ABLATE" not in (REPO / "sema_tpu_torch" / "ops" /
                                 "_cuda.py").read_text()
    # the product's build of every source has no macro
    assert _cuda.lib_path("encoder_layer").name.startswith(
        "libencoder_layer-")
    assert "SEMA_ABLATE1" in _cuda.lib_path("encoder_layer",
                                            ("SEMA_ABLATE=1",)).name


def test_cuda_request_without_a_card_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="is_available"):
        device.resolve_device()
    with pytest.raises(RuntimeError, match="is_available"):
        device.resolve_device("cuda")
    assert device.resolve_device("cpu") == torch.device("cpu")
    with pytest.raises(ValueError, match="unsupported device"):
        device.resolve_device("meta")
    spec = get_spec("test-tiny")
    with pytest.raises(RuntimeError, match="is_available"):
        Encoder(spec, random_params(spec), HashTokenizer(spec.vocab_size))
    with pytest.raises(RuntimeError, match="is_available"):
        VectorStore(tmp_path, spec.dim, spec.name)
    monkeypatch.setenv("SEMA_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SEMA_TPU_DATA", str(tmp_path / "data"))
    with pytest.raises(RuntimeError, match="is_available"):
        cli.main(["query", "anything"])


def test_kernel_build_without_nvcc_raises(monkeypatch, tmp_path):
    monkeypatch.setattr(_cuda, "BUILD_DIR", tmp_path / "kernels")
    monkeypatch.setattr(_cuda.shutil, "which", lambda name: None)
    monkeypatch.setenv("CUDA_HOME", str(tmp_path / "no-cuda"))
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.build(["scan_topk"])
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _cuda.library("encoder_layer", {})
