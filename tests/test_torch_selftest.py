"""The port's device self-test (``sema_tpu_torch/selftest.py``) and
``doctor`` on the CPU: the cases of ``tests/test_selftest.py``, the check
names pinned against the JAX package's, and the checks' teeth (a scan that
returns a wrong row, a probe forced to the exact scan)."""

import io
from contextlib import redirect_stdout

import pytest
import torch

from sema_tpu.selftest import run_device_selftest as jax_selftest
from sema_tpu_torch import cli
from sema_tpu_torch.config import ModelConfig
from sema_tpu_torch.index import vector_store
from sema_tpu_torch.index.vector_store import VectorStore
from sema_tpu_torch.selftest import NOT_PORTED, run_device_selftest

NAMES = ["scan-ids", "scan-int8", "scan-mesh", "scan-spill", "scan-ivf",
         "scan-spill-ivf", "encoder-parity"]


def test_selftest_all_green_on_cpu():
    cfg = ModelConfig(name="test-tiny", max_length=32, batch_size=8)
    checks = run_device_selftest(cfg, dim=64, device="cpu")
    assert [n for n, _, _ in checks] == NAMES
    for name, ok, detail in checks:
        assert ok, f"{name}: {detail}"


def test_selftest_scan_only():
    checks = run_device_selftest(None, dim=32, with_encoder=False,
                                 device="cpu")
    assert len(checks) == 6
    assert all(ok for _, ok, _ in checks)


def test_selftest_int8_encoder_parity():
    cfg = ModelConfig(name="test-tiny", max_length=32, batch_size=8,
                      quant="int8")
    checks = run_device_selftest(cfg, dim=64, device="cpu")
    parity = dict((n, (ok, d)) for n, ok, d in checks)["encoder-parity"]
    assert parity[0], parity[1]
    assert "quant=int8" in parity[1]


def test_check_names_are_the_jax_packages_less_the_unported():
    """Every JAX check is run here or named in NOT_PORTED, in the JAX
    package's order; each unported one says why."""
    from sema_tpu.config import ModelConfig as JaxModelConfig
    jax_names = [n for n, _, _ in jax_selftest(
        JaxModelConfig(name="test-tiny", max_length=32, batch_size=8),
        dim=32)]
    assert jax_names == [
        "scan-ids", "scan-ids-pallas", "scan-int8", "scan-mesh",
        "scan-spill", "scan-ivf", "scan-spill-ivf", "encoder-parity"]
    assert [n for n in jax_names if n not in NOT_PORTED] == NAMES
    assert sorted(NOT_PORTED) == ["scan-ids-pallas"]
    assert all(NOT_PORTED.values())


# the scan wrapper each check's probes reach, by the name the store calls
SCAN_OF = {"scan-ids": "scan_topk", "scan-int8": "scan_topk_int8",
           "scan-mesh": "scan_topk", "scan-spill": "scan_topk", "scan-ivf": "scan_topk_pruned",
           "scan-spill-ivf": "scan_topk_pruned"}


def _ties_swapped(scan):
    """``scan`` with the ids of each run of equal scores in reverse: a
    merge that ranks equal scores by anything but the row id."""
    def call(*args, **kwargs):
        s, i = scan(*args, **kwargs)
        i = i.clone()
        for q, row in enumerate(s.tolist()):
            lo = 0
            while lo < len(row):
                hi = lo
                while hi + 1 < len(row) and row[hi + 1] == row[lo]:
                    hi += 1
                i[q, lo:hi + 1] = i[q, lo:hi + 1].flip(0)
                lo = hi + 1
        return s, i
    return call


def _no_row_scale(scan):
    """An int8 scan that multiplies no row's scale into its dots."""
    def call(qvals, scales, *args, **kwargs):
        return scan(qvals, torch.ones_like(scales), *args, **kwargs)
    return call


def _wrong_row(scan):
    def call(*args, **kwargs):
        s, i = scan(*args, **kwargs)
        return s, torch.full_like(i, 2)
    return call


@pytest.mark.parametrize("name, fault, want", [
    *[pytest.param(n, "wrong_row", "planted winners missed: row 0 ->", id=n)
      for n in SCAN_OF],
    pytest.param("scan-ids", "ties_swapped",
                 "planted winners missed: equal rows [20, 21, 90, 140, 290]"
                 " -> ['r290', 'r140', 'r90', 'r21', 'r20'",
                 id="scan-ids-ties-swapped"),
    pytest.param("scan-int8", "no_row_scale",
                 "planted winners missed: row 10 among flat decoys -> r",
                 id="scan-int8-no-row-scale")])
def test_scan_check_fails_on_a_wrong_row_id(name, fault, want, monkeypatch):
    """The store's scan answers row 2 in every slot (never a planted
    winner's row, whatever the order); or it reverses the ids of equal
    scores (a lost tie order); or, over int8 rows, it leaves out every
    row's scale: the check must fail, on the row that shows it."""
    scan = getattr(vector_store, SCAN_OF[name])
    faults = {"wrong_row": _wrong_row, "ties_swapped": _ties_swapped,
              "no_row_scale": _no_row_scale}
    monkeypatch.setattr(vector_store, SCAN_OF[name], faults[fault](scan))
    checks = dict((n, (ok, d)) for n, ok, d in run_device_selftest(
        None, dim=32, with_encoder=False, device="cpu"))
    ok, detail = checks[name]
    assert not ok and want in detail, detail
    assert all(checks[n][0] for n in checks
               if SCAN_OF.get(n) != SCAN_OF[name]), checks


@pytest.mark.parametrize("name, route", [
    ("scan-ivf", "_ivf_scan"), ("scan-spill-ivf", "_ivf_spill_dispatch")])
def test_pruned_dispatch_guard_fails_on_the_exact_scan(name, route,
                                                       monkeypatch):
    """A probe forced to the exact scan still finds every planted winner,
    and the guard alone must fail the check."""
    monkeypatch.setattr(VectorStore, route, lambda self, *a, **k: None)
    checks = dict((n, (ok, d)) for n, ok, d in run_device_selftest(
        None, dim=32, with_encoder=False, device="cpu"))
    ok, detail = checks[name]
    assert not ok
    misses = detail.rsplit(" [", 1)[0].split(": ", 1)[1].split("; ")
    assert len(misses) == 5 and all(
        m.endswith("probe fell back to the exact scan (pruned kernel "
                   "never dispatched)") for m in misses), detail
    assert all(checks[n][0] for n in checks if n != name)


def _doctor(tmp_path, monkeypatch, *flags):
    monkeypatch.setenv("SEMA_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SEMA_TPU_DATA", str(tmp_path / "data"))
    out = io.StringIO()
    with redirect_stdout(out):
        rc = cli.main(["doctor", "--device", "cpu", "--model", "test-tiny",
                       *flags])
    return rc, out.getvalue()


def test_doctor_skip_quality_on_cpu(tmp_path, monkeypatch):
    rc, out = _doctor(tmp_path, monkeypatch, "--skip-quality")
    assert rc == 0, out
    lines = [line for line in out.splitlines() if line.startswith("device ")]
    assert [line.split(":", 1)[0].split()[1] for line in lines] \
        == NAMES + list(NOT_PORTED)
    for line in lines[:len(NAMES)]:
        assert line.split(": ", 1)[1].startswith("ok — "), line
    for line in lines[len(NAMES):]:
        assert line.split(": ", 1)[1].startswith("n/a — "), line
    assert "card             : not used (--device cpu" in out
    assert "model            : test-tiny (64-d" in out
    assert "weights          : random" in out
    assert "quality gate" not in out


def test_doctor_skips_the_quality_gate_on_random_weights(tmp_path,
                                                         monkeypatch):
    rc, out = _doctor(tmp_path, monkeypatch)
    assert rc == 1
    assert "quality gate     : SKIPPED — encoder has random-init weights" \
        in out
    assert "RESULT" not in out


def test_doctor_fails_when_a_check_fails(tmp_path, monkeypatch):
    monkeypatch.setattr(VectorStore, "_ivf_scan", lambda self, *a, **k: None)
    rc, out = _doctor(tmp_path, monkeypatch, "--skip-quality")
    assert rc == 1
    assert any(line.startswith("device scan-ivf ") and ": FAIL — " in line
               for line in out.splitlines()), out


def test_doctor_exits_1_when_the_kernels_do_not_build(tmp_path, monkeypatch,
                                                     capsys):
    """On a card, doctor builds the kernels first; a build that fails is a
    KernelError, and doctor ends with exit 1 and the kernel's message
    before it loads a model."""
    from sema_tpu_torch.ops import _cuda

    def no_build(names=None):
        raise _cuda.KernelError("kernel build failed: planted")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "current_device", lambda: 0)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda d=None: "card")
    monkeypatch.setattr(_cuda, "build", no_build)
    monkeypatch.setenv("SEMA_TPU_HOME", str(tmp_path / "home"))
    monkeypatch.setenv("SEMA_TPU_DATA", str(tmp_path / "data"))
    assert cli.main(["doctor", "--skip-quality"]) == 1
    out, err = capsys.readouterr()
    assert "card             : card (1 device(s))" in out
    assert "Error: a CUDA kernel failed: kernel build failed: planted" in err
    assert "model            :" not in out
