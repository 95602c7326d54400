"""What ``make_sharded_env`` sends between ranks, on gloo ranks of their own.

Each rank steps its own slab of the row (of the Navier-Stokes field's rows)
and trades halos through ``parallel/spatial.py::_XAxis``. Counted in one
``step_batch``, with ``CommDebugMode`` (DTensor's collectives and the
``torch.distributed`` collectives) and a spy on ``torch.distributed``
(``tests/torch_ranks.py::CommSpy``):

- transport, Burgers, explicit reaction-diffusion and the PCR implicit one,
  at ``(env=1, x=2)`` and ``(env=1, x=4)``: the all-gathers of one action are
  the same at S and at 2S sub-steps (none gathers in a sub-step), no gathered
  tensor has the row's length, and the elements a rank sends along ``x`` in
  a sub-step, ``(sent(2S) - sent(S)) / S``, are at most 4 x its local envs x
  the halo width (one point; PCR: the θ-scheme's two rolls and, for each of
  its steps, its stride, at most the slab's width, both ways);
- Navier-Stokes 8 x 8 at ``(env=1, x=4)``: two all-gathers a step, where the
  wrapper that gathered the whole field for every op gathered 24: the
  direct solve's divergence, whose spectral products take every row, and the
  frames of the observation, which the placement rule replicates over ``x``.

The row families and Navier-Stokes are also held against their unsharded
rollouts at ``(env=1, x=4)``, in the bands of
``tests/test_torch_dist_sharded_env.py`` (which holds them at ``(env=2,
x=2)``), and each exchange of the axis against its one-rank form on uneven
slabs. ``tests/test_torch_axis_one_rank.py`` holds the unsharded steps to the
formulas they had before they were written against the axis.
"""

import numpy as np
import pytest

from torch_ranks import run_ranks

HALO_FAMILIES = ["transport", "burgers", "rd_explicit", "rd_implicit"]


@pytest.fixture(scope="module", params=[2, 4], ids=["x2", "x4"])
def halo_counts(request, tmp_path_factory):
    shards = request.param
    outs = run_ranks("halo_counts", shards, tmp_path_factory.mktemp(f"halo{shards}"),
                     HALO_FAMILIES, shards, 4, 3, join="rank", timeout=300.0)
    return shards, outs


def _pcr_width(size, length):
    """The points of each array a rank of at most ``size`` points sends in a
    PCR sub-step, both ways: one for each of the θ-scheme's two rolls, and for
    each PCR step its stride, at most the slab, to each side."""
    from pdecontrolgym_tpu_torch.ops.tridiag import pcr_steps

    return 2 * (1 + sum(min(2 ** s, size) for s in range(pcr_steps(length))))


@pytest.mark.parametrize("family", HALO_FAMILIES)
def test_no_gather_in_a_sub_step(family, halo_counts):
    shards, outs = halo_counts
    for rank, out in enumerate(outs):
        fam = out[family]
        one, two = fam["runs"][1], fam["runs"][2]
        assert two["S"] == 2 * one["S"]
        assert one["gathers"] == two["gathers"], (rank, one["counts"], two["counts"])
        assert one["gathers"] == 0, (rank, one["counts"])  # the obs is the slab
        assert len(one["gathered"]) == len(two["gathered"])
        for shape in one["gathered"] + two["gathered"]:
            assert fam["length"] not in shape, (rank, shape)


@pytest.mark.parametrize("family", HALO_FAMILIES)
def test_halo_traffic_a_sub_step(family, halo_counts):
    shards, outs = halo_counts
    for rank, out in enumerate(outs):
        fam = out[family]
        one, two = fam["runs"][1], fam["runs"][2]
        per_sub_step = (two["sent"] - one["sent"]) / one["S"]
        width = (_pcr_width(max(fam["sizes"]), fam["length"]) if family == "rd_implicit"
                 else 1)
        bound = 4 * fam["local_envs"] * width
        assert 0 < per_sub_step <= bound, (rank, per_sub_step, bound)


def test_ns_gathers_twice_a_step(tmp_path):
    outs = run_ranks("halo_ns_counts", 4, tmp_path, 4, 4, 5, join="rank")
    for rank, out in enumerate(outs):
        assert out["gathers"] == 2, (rank, out["counts"])
        # the divergence's interior rows (6 of the 8) and the frames
        assert out["gathered"] == [(1, 4, 2, 6)], (rank, out["gathered"])


@pytest.fixture(scope="module")
def x4_rollouts(tmp_path_factory):
    families = ["transport", "burgers", "rd_explicit", "rd_implicit", "rd_thomas",
                "rd_dense", "ns"]
    return run_ranks("sharded_family_rollouts", 4, tmp_path_factory.mktemp("x4"),
                     families, 4, 4, 3, 7, join="rank", timeout=300.0)


@pytest.mark.parametrize("family", ["transport", "burgers", "rd_explicit", "rd_implicit",
                                    "rd_thomas", "rd_dense", "ns"])
def test_x4_rollout_matches_unsharded(family, x4_rollouts):
    """Four slabs a row (uneven for reaction-diffusion's ghost point; PCR's
    strides reach past the next rank), against the unsharded rollout."""
    for ranks in x4_rollouts:
        out = ranks[family]
        s, u = out["sharded"], out["unsharded"]
        for name in u["state"]:
            rtol, atol = ((1e-5, 1e-6) if name in ("u", "v") else (1e-4, 1e-4)) \
                if family == "ns" else (1e-5, 1e-5)
            np.testing.assert_allclose(s["state"][name].numpy(), u["state"][name].numpy(),
                                       rtol=rtol, atol=atol, err_msg=name)
        rtol, atol = (1e-5, 1e-6) if family == "ns" else (1e-4, 1e-4)
        np.testing.assert_allclose(s["reward"].numpy(), u["reward"].numpy(),
                                   rtol=rtol, atol=atol)


@pytest.mark.parametrize("world,length", [(2, 9), (3, 10), (4, 33)])
def test_axis_exchanges_match_one_rank(world, length, tmp_path):
    """Shifts past the next rank and past the row, rolls, halos, heads,
    tails, sums and gathers on slabs of unequal width."""
    shifts = [1, -1, 3, -4, length - 1, -(length + 2)]
    outs = run_ranks("axis_exchanges", world, tmp_path, length, shifts, 11, join="rank")
    for rank, errs in enumerate(outs):
        bad = {k: v for k, v in errs.items() if not v < 1e-12}
        assert not bad, (rank, bad)
