# Copy of sema_tpu/config.py with imports renamed; tests/test_torch_imports.py checks it for drift.
"""Configuration system.

Parity: mirrors the reference's ``src/config/mod.rs``:

- TOML config file auto-created with defaults on first run
  (ref: src/config/mod.rs:134-147) at ``~/.sema_tpu/config.toml``
  (the reference uses ``~/.sema/config.toml``, src/config/mod.rs:129-132;
  we use our own namespace so both can coexist; override with
  ``$SEMA_TPU_HOME``).
- ``[general]`` defaults are byte-for-byte the reference's
  (src/config/mod.rs:26-116): 10 MiB max size, ~70 extensions,
  6 exclude patterns, follow_symlinks=False, include_hidden=False,
  ignore_gitignore=True.
- CLI flags override the loaded config in memory only
  (ref: src/main.rs:31-59); see :func:`apply_cli_overrides`.

Extensions beyond the reference (it hardcodes these): ``[model]``,
``[index]`` and ``[mesh]`` sections for encoder choice, store dtype and
device-mesh layout (the reference hardcodes model at embeddings.rs:95,
dim 384 at lance_indexer.rs:43, max_len 256 at embeddings.rs:7).
"""

from __future__ import annotations

import os
import tomllib
from dataclasses import dataclass, field, asdict, replace
from pathlib import Path
from typing import Any, List, Optional

# Reference defaults, src/config/mod.rs:30-102.
DEFAULT_FILE_EXTENSIONS: List[str] = [
    "rs", "py", "js", "ts", "jsx", "tsx", "go", "java", "kt", "scala",
    "c", "cpp", "cc", "cxx", "h", "hpp", "cs", "rb", "php", "swift",
    "dart", "lua", "pl", "sh", "bash", "zsh", "fish", "ps1", "bat",
    "r", "jl", "hs", "elm", "clj", "ex", "erl", "vim", "asm", "s",
    "html", "htm", "css", "scss", "sass", "less", "vue", "svelte",
    "json", "yaml", "yml", "toml", "xml", "ini", "cfg", "conf",
    "properties", "env", "md", "markdown", "txt", "rst", "adoc",
    "asciidoc", "tex", "rtf", "sql", "graphql", "gql", "log", "csv", "tsv",
]

# Reference defaults, src/config/mod.rs:103-110.
DEFAULT_EXCLUDE_PATTERNS: List[str] = [
    ".git", "target", "node_modules", ".cache", "*.tmp", "*.log",
]


@dataclass
class GeneralConfig:
    """Crawl/ingest options (ref: src/config/mod.rs:11-19, defaults 26-116)."""

    max_file_size: int = 10_485_760
    file_extensions: List[str] = field(
        default_factory=lambda: list(DEFAULT_FILE_EXTENSIONS))
    exclude_patterns: List[str] = field(
        default_factory=lambda: list(DEFAULT_EXCLUDE_PATTERNS))
    follow_symlinks: bool = False
    include_hidden: bool = False
    ignore_gitignore: bool = True


@dataclass
class ModelConfig:
    """Encoder selection (the reference hardcodes MiniLM, embeddings.rs:7,95)."""

    name: str = "minilm-l6"          # key into sema_tpu.models.registry
    max_length: int = 256            # token truncation (ref embeddings.rs:7)
    batch_size: int = 256            # device batch for index-build embedding
    dtype: str = "bfloat16"          # compute dtype on TPU
    quant: str = "none"              # "int8" => W8A8 linears (2× MXU rate)
    weights_path: str = ""           # local safetensors dir; "" => HF cache / random


@dataclass
class IndexConfig:
    """Vector-store layout (the reference hardcodes dim 384, lance_indexer.rs:43)."""

    store_dtype: str = "bfloat16"    # bf16 store; "int8" => quantized scan + rescore
    rescore_k: int = 100             # bf16 rescore depth for int8 scans
    segment_rows: int = 65536        # rows per append segment (device tile multiple)
    result_limit: int = 50           # ref engine.rs:11 SEARCH_RESULTS_LIMIT
    hbm_budget_mb: float = 0.0       # device-bucket cap; 0 = auto (PJRT limit
                                     # or unlimited); past it, buckets stream
                                     # from host (HBM spill, docs/PERF.md)
    ivf: bool = False                # cluster sealed buckets (device k-means)
                                     # and prune small-batch scans to the
                                     # probed clusters' tiles (ANN; the exact
                                     # scan stays the default and the
                                     # fallback). Capability increase over
                                     # the reference (LanceDB offers IVF but
                                     # lance_indexer.rs never builds one).
    ivf_nprobe: int = 32             # clusters probed per query in IVF mode
    ivf_min_recall: float = 0.0      # recall contract (docs/API.md): mean
                                     # recall@10 target mapped to nprobe via
                                     # the measured frontier; >= 0.97 routes
                                     # every query to the exact scan (the
                                     # only per-query recall floor). 0 = off.


@dataclass
class MeshConfig:
    """Device mesh layout for multi-chip runs."""

    data_axis: str = "data"          # DP axis for the encoder batch
    index_axis: str = "index"        # axis the N×d store is sharded over
    shape: List[int] = field(default_factory=list)  # [] => all local devices on index axis
    # Megatron tensor parallelism for large encoders (models/tp.py):
    # name the TP axis (e.g. "model") and give a matching 3-entry shape
    # — cli.py then builds a (data, model, index) mesh, the encoder
    # shards qkv/ffn over it (fused kernels + int8 compose), and the
    # store keeps sharding over index (replicated across model). Empty
    # = off (the default: every in-tree model fits one chip).
    model_axis: str = ""
    # Multislice (BASELINE config 5, e.g. 100M rows on v5p-32): name the
    # axis that maps ACROSS slices (DCN) and give a matching explicit
    # shape with the slice axis FIRST — cli.py builds a
    # (slice, data[, model], index) mesh, store rows shard over
    # (slice, index), and candidate merges run two-level: within the
    # slice over ICI, slice winners over DCN (parallel/multislice.py).
    # Empty = off.
    slice_axis: str = ""


@dataclass
class TuiConfig:
    """TUI extensions beyond reference parity (all off by default —
    the reference searches only on Enter, src/tui/events.rs:30-37)."""

    incremental_search: bool = False  # search-as-you-type (debounced)
    incremental_debounce_ms: int = 300


@dataclass
class Config:
    general: GeneralConfig = field(default_factory=GeneralConfig)
    model: ModelConfig = field(default_factory=ModelConfig)
    index: IndexConfig = field(default_factory=IndexConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    tui: TuiConfig = field(default_factory=TuiConfig)


def _toml_escape(s: str) -> str:
    return s.replace("\\", "\\\\").replace('"', '\\"')


def _toml_value(v: Any) -> str:
    if isinstance(v, bool):
        return "true" if v else "false"
    if isinstance(v, (int, float)):
        return str(v)
    if isinstance(v, str):
        return f'"{_toml_escape(v)}"'
    if isinstance(v, (list, tuple)):
        return "[" + ", ".join(_toml_value(x) for x in v) + "]"
    raise TypeError(f"unsupported TOML value: {type(v)}")


def dumps_toml(config: Config) -> str:
    """Serialize a Config to TOML (tomllib is read-only; schema is flat)."""
    out = []
    for section, values in asdict(config).items():
        out.append(f"[{section}]")
        for key, val in values.items():
            out.append(f"{key} = {_toml_value(val)}")
        out.append("")
    return "\n".join(out)


def _load_section(cls, data: dict):
    known = {f for f in cls.__dataclass_fields__}
    return cls(**{k: v for k, v in data.items() if k in known})


def loads_toml(text: str) -> Config:
    data = tomllib.loads(text)
    return Config(
        general=_load_section(GeneralConfig, data.get("general", {})),
        model=_load_section(ModelConfig, data.get("model", {})),
        index=_load_section(IndexConfig, data.get("index", {})),
        mesh=_load_section(MeshConfig, data.get("mesh", {})),
        tui=_load_section(TuiConfig, data.get("tui", {})),
    )


class ConfigManager:
    """Create-on-first-run TOML config (ref: src/config/mod.rs:118-173)."""

    def __init__(self, home: Optional[Path] = None):
        self.config_dir = Path(
            home or os.environ.get("SEMA_TPU_HOME") or (Path.home() / ".sema_tpu"))
        self.config_file = self.config_dir / "config.toml"

    def init(self) -> None:
        """Create the config dir and a default config file if absent
        (ref: src/config/mod.rs:134-147)."""
        self.config_dir.mkdir(parents=True, exist_ok=True)
        if not self.config_file.exists():
            self.save_config(Config())

    def load_config(self) -> Config:
        """Load the config, writing defaults first if the file is missing
        (ref: src/config/mod.rs:149-163)."""
        if not self.config_file.exists():
            config = Config()
            self.save_config(config)
            return config
        return loads_toml(self.config_file.read_text())

    def save_config(self, config: Config) -> None:
        self.config_dir.mkdir(parents=True, exist_ok=True)
        self.config_file.write_text(dumps_toml(config))


def data_dir() -> Path:
    """Index storage location.

    The reference stores its index under the *user config dir*
    (``dirs::config_dir()/sema``, src/tui/app.rs:63-70) — one global index
    shared across every directory the tool is run in. We keep that semantic
    under ``$XDG_CONFIG_HOME/sema_tpu`` (or ``$SEMA_TPU_DATA`` override).
    """
    override = os.environ.get("SEMA_TPU_DATA")
    if override:
        return Path(override)
    xdg = os.environ.get("XDG_CONFIG_HOME")
    base = Path(xdg) if xdg else Path.home() / ".config"
    return base / "sema_tpu"


def apply_cli_overrides(config: Config, args) -> Config:
    """Apply CLI flags on top of the loaded config, in-memory only
    (ref: src/main.rs:31-59). ``--extensions`` *replaces* the default list;
    ``--exclude`` *appends* (deduplicated)."""
    g = config.general
    if getattr(args, "max_file_size", None) is not None:
        g.max_file_size = args.max_file_size
    if getattr(args, "include_hidden", False):
        g.include_hidden = True
    if getattr(args, "follow_symlinks", False):
        g.follow_symlinks = True
    if getattr(args, "ignore_gitignore", False):
        g.ignore_gitignore = True
    if getattr(args, "extensions", None):
        g.file_extensions = list(args.extensions)
    if getattr(args, "exclude", None):
        for pattern in args.exclude:
            if pattern not in g.exclude_patterns:
                g.exclude_patterns.append(pattern)
    if getattr(args, "model", None):
        config.model.name = args.model
    return config
