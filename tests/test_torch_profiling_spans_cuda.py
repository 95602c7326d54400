"""The port's spans on the card (``pdecontrolgym_tpu_torch/utils/profiling.py``):
a span that records under a device-only ``torch.profiler`` takes its device
time from two CUDA events on the current stream, pooled once read; off, it
makes no event.

Every test here is marked ``cuda`` and skips where there is no card. The file
imports nothing of the JAX package::

    python -m pytest tests/test_torch_profiling_spans_cuda.py -m cuda
"""

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from pdecontrolgym_tpu_torch.utils import profiling
from pdecontrolgym_tpu_torch.utils.profiling import clear_spans, span, span_totals


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")
    torch.cuda.init()
    clear_spans()


def _busy(x, times=20):
    for _ in range(times):
        x = x @ x
        x = x / x.norm()
    return x


@pytest.mark.cuda
def test_cuda_span_times_the_stream_with_pooled_events():
    _card()
    x = torch.randn(2048, 2048, device="cuda")
    _busy(x)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]):
        for _ in range(3):
            with span("work"):
                _busy(x)
            with span("nothing"):
                pass
    entries = profiling._RECORD.sessions[0]
    assert all(e.events is not None for e in entries)
    totals = span_totals()
    assert totals["work"]["count"] == 3 and totals["nothing"]["count"] == 3
    # the products run on the device after their launch: the stream's time
    # between the events far exceeds that of an empty span
    assert totals["work"]["device_s"] > 10 * totals["nothing"]["device_s"]
    assert totals["work"]["device_s"] > 0
    assert all(e.events is None for e in entries)
    pooled = len(profiling._RECORD.pool)
    assert pooled >= 2 * len(entries)
    assert span_totals() == totals
    clear_spans()
    with profile(activities=[ProfilerActivity.CUDA]):
        with span("again"):
            pass
    assert len(profiling._RECORD.pool) == pooled - 2
    clear_spans()


@pytest.mark.cuda
def test_cuda_off_span_makes_no_event(monkeypatch):
    _card()

    def refuse(*args, **kwargs):
        raise AssertionError("a CUDA event while no profiler records")

    monkeypatch.setattr(torch.cuda, "Event", refuse)
    with span("off"):
        _busy(torch.ones(8, 8, device="cuda"), 1)
    assert span_totals() == {}
