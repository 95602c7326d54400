"""One short cell on the card (``cuda``): the whole run at the cell's batch,
a short window, the check's episodes taken from the first two."""

import io
import json

import pytest


@pytest.mark.cuda
def test_transport_cell_on_the_card():
    torch = pytest.importorskip("torch")
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    from benchmark import harness

    out = io.StringIO()
    rc = harness.main(["--workload", "transport.bs.b65536", "--seed", "2147483777",
                       "--seconds", "2", "--trace", "1"],
                      overrides={"traffic": {"check_within": 2, "trace_from": 50}},
                      out=out)
    assert rc == 0
    result = json.loads(out.getvalue().strip().splitlines()[-1])
    assert result["correct"], result["checks"]
    assert result["device"]["platform"] == "gpu" and result["device"]["busy_s"] > 0
    assert 0 < result["metrics"]["interval_roofline.rollout"]["value"] <= 100
