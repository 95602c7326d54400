"""The launch shape of the neuron K-step kernels past ``MAX_M`` points
(``pdecontrolgym_tpu_torch/csrc/neuron_interval_wide.cu``), as
``ops/neuron_interval.py::wide_layout`` picks it from M. No card is needed;
the file imports nothing of the JAX package."""

import pytest

from pdecontrolgym_tpu_torch.ops import neuron_interval as tni


@pytest.mark.parametrize("M", [3, 121, tni.MAX_M, tni.MAX_M_WIDE + 1, 20000])
def test_no_wide_layout_outside_the_wide_rows(M):
    assert tni.wide_layout(M) is None


@pytest.mark.parametrize("M", [tni.MAX_M + 1, 601, 1201, tni.WARP_MAX_M])
def test_warp_per_env_up_to_the_crossover(M):
    """One warp an env up to WARP_MAX_M: as many envs a block (at most 16)
    as pB and the rows, each padded to 32 points, leave room for in a
    block's shared memory."""
    kind, envs = tni.wide_layout(M)
    stride = -(-M // 32) * 32
    assert kind == "warp" and 1 <= envs <= 16
    assert 4 * stride * (1 + envs) <= tni.SHARED_BYTES
    assert envs == 16 or 4 * stride * (2 + envs) > tni.SHARED_BYTES


@pytest.mark.parametrize("M", [tni.WARP_MAX_M + 1, 8192, 8193, tni.MAX_M_WIDE])
def test_block_per_env_past_the_crossover(M):
    """One block an env above WARP_MAX_M: ceil(M / 512) warps (at most 16)
    and the fewest points a lane that hold the row."""
    kind, warps, slots = tni.wide_layout(M)
    assert kind == "block" and warps == min(16, -(-M // 512))
    assert 32 * warps * slots >= M > 32 * warps * (slots - 1)
    assert 9 <= slots <= 32


def test_the_crossover_lies_inside_the_wide_rows():
    assert tni.MAX_M < tni.WARP_MAX_M < tni.MAX_M_WIDE
    assert tni.wide_layout(tni.WARP_MAX_M)[0] == "warp"
    assert tni.wide_layout(tni.WARP_MAX_M + 1)[0] == "block"
