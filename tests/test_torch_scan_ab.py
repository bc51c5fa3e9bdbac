"""The scan A/B tools of the port (``sema_tpu_torch.tools.scan_ab15`` and
``scan_ab14``) on ``--device cpu`` at a few thousand rows: they exit 0
with ids identical and end on the JAX tools' JSON keys; their data is the
JAX tools' own, from the same numpy seeds."""

import json

import numpy as np
import pytest

from sema_tpu_torch.tools import scan_ab14, scan_ab15

# tools/scan_ab15.py's last line (scan_ab14.py prints none; its port ends
# on the same keys)
JAX_KEYS = {"rows", "dim", "qbatch", "k", "ids_identical", "ms"}


def _run(main, argv, capsys):
    rc = main(argv)
    out = capsys.readouterr().out.strip().splitlines()
    return rc, out, json.loads(out[-1])


def test_scan_ab15_on_the_cpu(capsys):
    rc, _, last = _run(scan_ab15.main, [
        "--rows", "3000", "--dim", "64", "--qbatch", "8", "--k", "10",
        "--warm", "128", "1024", "--device", "cpu"], capsys)
    assert rc == 0 and JAX_KEYS <= set(last) and last["ids_identical"]
    assert (last["rows"], last["dim"], last["qbatch"], last["k"]) == (
        3000, 64, 8, 10)
    assert set(last["ms"]) == {"cold", "warm128", "warm1024", "cold_q1",
                               "warm128_q1", "warm1024_q1"}
    assert last["device"] == "cpu"
    # the plain versions count no launch
    assert last["launches"] == {"scan_topk": 0, "scan_topk_warm": 0}


def test_scan_ab15_k_beyond_warm_raises():
    with pytest.raises(ValueError):
        scan_ab15.main(["--rows", "512", "--dim", "64", "--qbatch", "2",
                        "--k", "10", "--warm", "5", "--device", "cpu"])


@pytest.mark.parametrize("argv", [
    ["--rows", "3000", "--dim", "64", "--q", "8", "--k", "10"],
    ["--small"]])
def test_scan_ab14_on_the_cpu(capsys, argv):
    rc, out, last = _run(scan_ab14.main, argv + ["--device", "cpu"], capsys)
    assert rc == 0 and JAX_KEYS <= set(last) and last["ids_identical"]
    if argv == ["--small"]:
        assert "small semantics: OK" in out
        assert (last["rows"], last["dim"], last["qbatch"]) == (8192, 128, 8)
    else:
        assert "ids equal: True  scores equal: True" in out
        assert set(last["ms"]) == {"shipped", "fold", "shipped_again"}


def test_tools_make_the_jax_tools_data():
    """The first rows come from the JAX tools' generators: seed 0,
    f64 normals cast to f32, unit rows (scan_ab15); seed 1, f32 normals
    (scan_ab14); the small check's planted ties."""
    store, qsets = scan_ab15.make_data(16, 8, 3)
    rng = np.random.default_rng(0)
    want = rng.standard_normal((16, 8)).astype(np.float32)
    want /= np.linalg.norm(want, axis=1, keepdims=True)
    np.testing.assert_array_equal(store, want)
    assert qsets.shape == (4, 3, 8)
    np.testing.assert_allclose(np.linalg.norm(qsets, axis=2), 1, atol=1e-6)
    store, qsets = scan_ab14.make_data(16, 8, 3)
    rng = np.random.default_rng(1)
    np.testing.assert_array_equal(
        store, rng.standard_normal((16, 8), dtype=np.float32))
    small, q = scan_ab14.small_data()
    assert small.shape == (8192, 128) and q.shape == (8, 128)
    assert (small[4096] == small[100]).all()
    assert (small[5000] == small[5001]).all()
