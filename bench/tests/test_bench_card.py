"""The harness on the card at the fixtures' size: the device's numbers
come out and stay inside their range.  Marked ``cuda``; skips here."""
import pytest
import torch

from bench import harness
from fixtures import CELLS, tiny_cell


@pytest.mark.cuda
@pytest.mark.parametrize("name", CELLS)
def test_traced_run_on_the_card(name):
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from bench.card import CudaCard
    res = harness.run_cell(tiny_cell(name), 17, 0.5, True,
                           CudaCard(torch, 1))
    assert res["correct"] is True
    dev = res["device"]
    assert dev["platform"] == "gpu" and dev["memory_peak_bytes"] > 0
    assert 0 < dev["busy_s"] <= dev["window_s"]
    m = res["metrics"]
    assert 0 <= m["idle_pct"]["value"] < 100
    assert 0 < m["device_busy_ms"]["value"] <= m["superstep_ms"]["value"] * 2
    assert 0 < m["ell_spmv_roofline"]["value"] <= 105
    assert res["breakdown"]["device_ops"]
