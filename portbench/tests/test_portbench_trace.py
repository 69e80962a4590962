"""The trace reduction on a hand-made trace: busy time, kernels launched
inside a named host range, and idle gaps by host operation."""

import pytest
from conftest import ROOT  # noqa: F401  (puts the checkout on sys.path)

from portbench.harness.trace import WINDOW, reduce


def _x(cat, name, ts, dur, tid=1, corr=None, pid=1):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
         "pid": pid, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


EVENTS = [
    _x("user_annotation", WINDOW, 0, 1000),
    _x("cpu_op", "_Flash", 100, 50),
    _x("cuda_runtime", "cudaLaunchKernel", 110, 5, corr=7),
    _x("kernel", "flash_fwd", 200, 100, tid=7, corr=7, pid=0),
    _x("cpu_op", "autograd::engine::evaluate_function: _FlashBackward",
       400, 100, tid=2),
    _x("cpu_op", "_FlashBackward", 405, 90, tid=2),
    _x("cpu_op", "aten::mul", 410, 10, tid=2),
    _x("cuda_runtime", "cudaLaunchKernel", 412, 3, tid=2, corr=8),
    _x("kernel", "mul", 450, 20, tid=7, corr=8, pid=0),
    _x("cuda_runtime", "cudaLaunchKernel", 600, 3, corr=9),
    _x("kernel", "sgemm_long", 700, 400, tid=7, corr=9, pid=0),
]
FLASH = {"flash": lambda n: n == "_Flash" or n.endswith("_FlashBackward")}


def test_reduce_counts_what_it_should():
    out = reduce(EVENTS, FLASH)
    assert out["window_s"] == pytest.approx(1000e-6)
    # the last kernel is clipped at the window's end
    assert out["busy_s"] == pytest.approx((100 + 20 + 300) * 1e-6)
    flash = out["ranges"]["flash"]
    assert flash["device_s"] == pytest.approx(120e-6)
    assert (flash["fwd_calls"], flash["bwd_calls"]) == (1, 1)
    assert out["device_ops"][0][0] == "sgemm_long"
    gaps = dict(out["idle_gaps"])
    assert gaps["_Flash"] == pytest.approx(200e-6)     # before flash_fwd
    assert gaps["aten::mul"] == pytest.approx(150e-6)  # before mul
    assert sum(gaps.values()) == pytest.approx(580e-6)


def test_reduce_without_device_events():
    out = reduce([_x("user_annotation", WINDOW, 0, 500)], FLASH)
    assert out["busy_s"] == 0 and out["device_events"] == 0
    assert out["ranges"]["flash"]["device_s"] == 0
