"""The port's mesh over several distinct cards, on the CPU: a host of 4 or
8 cards faked by ``torch.cuda.device_count``/``is_available`` (no tensor is
allocated on a card). The CLI's mesh (``cli.config_mesh``) against the
JAX CLI's on as many of the JAX tests' virtual CPU devices, for the
configs a user writes; then where the port puts each shard's work over
distinct device objects: ``shard_devices``, ``shard_params_tp``, the
encoder's data-parallel params and the sharded store's row blocks, each
placement read from the targets of ``Tensor.to``; and the timers' wait on
each card of a mesh."""

import jax
import numpy as np
import pytest
import torch

from sema_tpu import cli as jax_cli
from sema_tpu import models as jax_models
from sema_tpu.config import Config as JaxConfig
from sema_tpu_torch import cli, tools
from sema_tpu_torch import models as torch_models
from sema_tpu_torch.config import Config
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.models.encoder import Encoder
from sema_tpu_torch.models.loader import random_params
from sema_tpu_torch.models.registry import get_spec
from sema_tpu_torch.models.tp import shard_params_tp
from sema_tpu_torch.parallel.mesh import make_mesh
from sema_tpu_torch.parallel.sharded_topk import shard_devices
from sema_tpu_torch.tokenizer import HashTokenizer

# (model_axis, slice_axis, shape) of a [mesh] table, by the host's cards
CONFIGS = {
    4: [("", "", []), ("", "", [4, 1]), ("model", "", [1, 4, 1]),
        ("model", "", [2, 2, 1]), ("", "slice", [2, 1, 2])],
    8: [("", "", []), ("", "", [8, 1]), ("model", "", [1, 8, 1]),
        ("model", "", [2, 4, 1]), ("", "slice", [2, 1, 4])],
}


def cards(n):
    return [torch.device("cuda", i) for i in range(n)]


@pytest.fixture
def host(monkeypatch):
    """A host of n cards as torch sees it, and n of the JAX tests'
    virtual CPU devices as JAX sees them."""
    def fake(n):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: n)
        monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
        devices = jax.devices()[:n]
        assert len(devices) == n
        monkeypatch.setattr(jax, "devices", lambda *a: devices)
        monkeypatch.setattr(jax, "device_count", lambda *a: n)
    return fake


class Captured(Exception):
    pass


def capture(monkeypatch, module):
    """``module.Encoder.from_config`` raising its arguments: the mesh and
    axes a CLI hands the encoder, before any model is built."""
    def stop(model_cfg, **kw):
        raise Captured(kw)
    monkeypatch.setattr(module.Encoder, "from_config", staticmethod(stop))


def mesh_config(config, model_axis, slice_axis, shape):
    config.mesh.model_axis, config.mesh.slice_axis = model_axis, slice_axis
    config.mesh.shape = list(shape)
    return config


@pytest.mark.parametrize("n, config", [
    pytest.param(n, c, id=f"{n}-{c[0] or c[1] or 'mesh'}-"
                          + "x".join(map(str, c[2] or ["default"])))
    for n, cs in CONFIGS.items() for c in cs])
def test_cli_mesh_is_the_jax_clis(n, config, host, monkeypatch):
    """The same [mesh] table gives the same axes, shape and shard order on
    n cards as the JAX CLI on n devices, and the encoder splits its batch
    over the same axis with the same model axis."""
    host(n)
    capture(monkeypatch, jax_models)
    with pytest.raises(Captured) as jax_run:
        jax_cli.make_index_manager(mesh_config(JaxConfig(), *config))
    want = jax_run.value.args[0]
    got = cli.config_mesh(mesh_config(Config(), *config), "cuda")
    capture(monkeypatch, torch_models)
    with pytest.raises(Captured) as torch_run:
        cli.make_index_manager(mesh_config(Config(), *config), "cuda")
    kw = torch_run.value.args[0]
    jax_mesh = want["mesh"]
    assert got.axis_names == tuple(jax_mesh.axis_names)
    assert got.shape == dict(jax_mesh.shape)
    assert [d.index for d in got.devices.flat] \
        == [d.id for d in jax_mesh.devices.flat]
    assert got.devices.flat[0] == torch.device("cuda", 0)
    assert (kw["data_axis"], kw["model_axis"]) \
        == (want["data_axis"], want["model_axis"])
    assert kw["mesh"].axis_names == got.axis_names


def test_one_card_has_no_mesh(host):
    host(1)
    assert cli.config_mesh(Config(), "cuda") is None
    assert cli.config_mesh(Config(), "cpu") is None


@pytest.mark.parametrize("n", [4, 8])
def test_shard_devices_follow_the_mesh(n, host):
    host(n)
    mesh = make_mesh([1, n], ("data", "index"), devices=cards(n))
    assert shard_devices(mesh, "index") == cards(n)
    sliced = make_mesh([2, 1, n // 2], ("slice", "data", "index"),
                       devices=cards(n))
    # slice-major: shard s * (n / 2) + c is slice s's card c
    assert shard_devices(sliced, ("slice", "index")) == cards(n)
    assert shard_devices(sliced, "index") == cards(n)[:n // 2]


@pytest.fixture
def placed(monkeypatch):
    """``Tensor.to`` a card recorded instead of done: the CPU tensor back,
    contiguous, with ``placed[id(result)]`` its card; a cast of such a
    tensor keeps its card."""
    targets = {}
    to = torch.Tensor.to

    def fake_to(self, *args, **kwargs):
        dev = kwargs.get("device", args[0] if args else None)
        if isinstance(dev, (str, torch.device)) and \
                torch.device(dev).type == "cuda":
            rest = {k: v for k, v in kwargs.items()
                    if k in ("dtype", "copy")}
            rest.update({"dtype": a for a in args[1:]
                         if isinstance(a, torch.dtype)})
            out = to(self, "cpu", **rest).contiguous().clone()
            targets[id(out)] = torch.device(dev)
            keep.append(out)
            return out
        out = to(self, *args, **kwargs)
        if id(self) in targets and out is not self:
            targets[id(out)] = targets[id(self)]
            keep.append(out)
        return out
    keep = []
    monkeypatch.setattr(torch.Tensor, "to", fake_to)
    return targets


@pytest.mark.parametrize("shape", [[1, 4], [2, 2]])
def test_tp_shards_lie_on_their_cards(shape, host, placed):
    """Each (data, model) entry's tree holds its model index's shard, every
    leaf on that entry's card; entries on distinct cards never share a
    tree."""
    host(4)
    spec = get_spec("test-tiny")
    params = random_params(spec, seed=0)
    mesh = make_mesh(shape, ("data", "model"), devices=cards(4))
    trees = shard_params_tp(params, mesh, "model")
    tp = mesh.shape["model"]
    for idx in np.ndindex(*mesh.devices.shape):
        tree = trees[idx]
        dev = mesh.devices[idx]
        for group in ("embeddings", "layers"):
            for name, leaf in tree[group].items():
                assert placed[id(leaf)] == dev, (idx, group, name)
        full = params["layers"]["ffn_in_w"].shape[-1]
        assert tree["layers"]["ffn_in_w"].shape[-1] == full // tp
    ids = [id(trees[idx]) for idx in np.ndindex(*mesh.devices.shape)]
    assert len(set(ids)) == 4


def test_dp_encoder_params_on_every_card(host, placed):
    """A (data 4) mesh: the encoder's params once on each card, the first
    card its own device, the batch in four parts."""
    host(4)
    spec = get_spec("test-tiny")
    mesh = make_mesh([4, 1], ("data", "index"), devices=cards(4))
    enc = Encoder(spec, random_params(spec, seed=0),
                  HashTokenizer(spec.vocab_size), max_length=32,
                  batch_size=6, mesh=mesh, data_axis="data")
    assert enc.device == torch.device("cuda", 0) and enc._dp == 4
    assert enc.batch_size == 8
    got = [placed[id(row[0]["embeddings"]["word"])] for row in enc.shards]
    assert got == cards(4)
    assert len({id(row[0]) for row in enc.shards}) == 4


@pytest.mark.parametrize("slices", [0, 2])
def test_store_blocks_lie_on_their_cards(slices, host, placed, tmp_path):
    """The sharded store cuts a bucket's rows into equal blocks, block s
    on shard s's card (slice-major over a slice axis), its first card
    the store's own."""
    host(4)
    axes = ("slice", "data", "index") if slices else ("data", "index")
    shape = [2, 1, 2] if slices else [1, 4]
    mesh = make_mesh(shape, axes, devices=cards(4))
    store = VectorStore(tmp_path, 8, "test-tiny", mesh=mesh,
                        slice_axis="slice" if slices else None)
    assert store.device == torch.device("cuda", 0)
    rows = torch.arange(64, dtype=torch.float32).reshape(16, 4)
    blocks = store._shard_blocks(rows)
    assert [placed[id(b)] for b in blocks] == cards(4)
    assert torch.equal(torch.cat(blocks), rows)
    assert [int(b[0, 0]) for b in blocks] == [0, 16, 32, 48]
    store.close()


def test_timers_wait_on_every_card(monkeypatch):
    """``synchronize`` waits on each card it is given, in turn, and on the
    current card alone when it is given none: a one-card timer touches
    no other card of the host."""
    waited = []
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(torch.cuda, "synchronize",
                        lambda device=None: waited.append(device))
    tools.synchronize(cards(4))
    assert waited == cards(4)
    waited.clear()
    tools.synchronize()
    assert waited == [None]
