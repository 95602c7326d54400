"""The launch layout of the brain-tumor field pass past 512 points (B8w,
``pdecontrolgym_tpu_torch/csrc/brain_tumor_field.cu``), as
``ops/brain_tumor_interval.py::wide_layout`` picks it from nx. No card is
needed; the file imports nothing of the JAX package."""

import re
from pathlib import Path

import pytest

from pdecontrolgym_tpu_torch.ops import brain_tumor_interval as tbt

SOURCE = (Path(tbt.__file__).resolve().parent.parent / "csrc" / "brain_tumor_field.cu").read_text()
WIDE_ROWS = range(tbt.MAX_NX + 1, tbt.MAX_NX_WIDE + 1)


def _constant(name):
    return int(re.search(rf"constexpr int {name} = (\d+);", SOURCE).group(1))


@pytest.mark.parametrize("py,cu", [("GROUP_ENVS", "kGroup"), ("MAX_STAGES", "kMaxStages"),
                                   ("RING_OFFSET", "kRingOffset"),
                                   ("SHARED_BYTES", "kSharedBytes"),
                                   ("MAX_NX_WIDE", "kMaxNxBrainWide")])
def test_the_layout_constants_are_the_kernels(py, cu):
    assert getattr(tbt, py) == _constant(cu)


@pytest.mark.parametrize("nx", [3, 201, tbt.MAX_NX, tbt.MAX_NX_WIDE + 1, 16384])
def test_no_wide_layout_outside_the_wide_rows(nx):
    assert tbt.wide_layout(nx) is None


def test_every_layout_fits_a_block_of_shared_memory():
    """At every row length of the reach: the streamed kernel's ring of 1 to
    MAX_STAGES stages of four rows, after its barriers, within the card's
    227 KiB a block; the block-per-env kernel's row and update (8 nx bytes)
    too."""
    for nx in WIDE_ROWS:
        kind, envs, stages = tbt.wide_layout(nx)
        if kind == "stream":
            assert envs == tbt.GROUP_ENVS and 1 <= stages <= tbt.MAX_STAGES
            assert tbt.stream_shared_bytes(nx, stages) <= tbt.SHARED_BYTES
        else:
            assert (kind, envs, stages) == ("block", 1, 0)
            assert 8 * nx <= tbt.SHARED_BYTES


def test_groups_of_four_envs_wherever_a_row_is_not_a_multiple_of_16_bytes():
    """A row of nx floats, nx not divisible by 4, is no multiple of 16 bytes;
    four consecutive rows always are, so the streamed kernel moves groups of
    four envs by bulk copies at every such nx."""
    streamed = [nx for nx in WIDE_ROWS if tbt.wide_layout(nx)[0] == "stream"]
    assert streamed and min(streamed) == tbt.MAX_NX + 1
    for nx in streamed:
        envs = tbt.wide_layout(nx)[1]
        assert envs == 4 and (4 * envs * nx) % 16 == 0
        assert nx % 4 == 0 or (4 * nx) % 16 != 0


@pytest.mark.parametrize("nx", [513, 801, 1201, 2049, 4097, 8192])
def test_the_ring_holds_as_many_stages_as_its_budget_allows(nx):
    kind, _, stages = tbt.wide_layout(nx)
    if kind == "block":
        assert nx > tbt.STREAM_MAX_NX
        return
    stage = 4 * tbt.GROUP_ENVS * nx
    assert stages == max(1, min(tbt.MAX_STAGES, tbt.RING_BYTES // stage))
    assert stages == tbt.MAX_STAGES or (stages + 1) * stage > tbt.RING_BYTES


def test_the_crossovers_are_where_the_layout_changes():
    """``wide_crossovers`` lists MAX_NX + 1 and every nx whose layout differs
    from nx - 1's, in order, and nothing else."""
    found = tbt.wide_crossovers()
    assert found[0] == tbt.MAX_NX + 1 and found == sorted(found)
    changes = [nx for nx in WIDE_ROWS if nx == tbt.MAX_NX + 1
               or tbt.wide_layout(nx) != tbt.wide_layout(nx - 1)]
    assert found == changes


@pytest.mark.parametrize("k,c", list(enumerate(tbt.wide_crossovers())))
def test_each_crossover_plus_and_minus_one(k, c):
    """One point below a crossover the layout is the one before it, at the
    crossover and one point past it the new one; fewer stages (or the
    block-per-env kernel) as rows grow."""
    assert tbt.wide_layout(c) == tbt.wide_layout(c + 1) or c == tbt.MAX_NX_WIDE
    below, at = tbt.wide_layout(c - 1), tbt.wide_layout(c)
    assert below != at
    if k == 0:
        assert below is None and at[0] == "stream"
    elif at[0] == "stream":
        assert below[0] == "stream" and at[2] < below[2]
    else:
        assert at == ("block", 1, 0) and c == tbt.STREAM_MAX_NX + 1


def test_the_main_path_row_streams():
    """brain_wide's 801 points (the stock domain at dx = 0.25) take the
    streamed kernel."""
    assert tbt.wide_layout(801)[0] == "stream"


@pytest.mark.parametrize("fields,streams", [
    (dict(), True), (dict(dx=0.25), True), (dict(k=2.0 ** 61), False),
    (dict(dx=2.0 ** -31), False), (dict(k=2.0 ** -60), True)])
def test_the_streamed_kernel_takes_divisors_of_the_reciprocal_domain(fields, streams):
    """``stream_takes``: k and dx * dx (as float32) within 2^-60 to 2^60, the
    domain of the reciprocal divisions (csrc/exact_div.cuh); a spec outside
    it goes to the block-per-env kernel."""
    base = dict(nx=801, dt=0.125, dx=1.0, D=0.05, rho=0.02, k=1e5, alpha=0.03,
                alpha_beta_ratio=10.0, t1_detection_threshold=0.8,
                t2_detection_threshold=0.16)
    spec = tbt.BrainTumorFieldSpec(**{**base, **fields})
    assert tbt.stream_takes(spec) is streams
