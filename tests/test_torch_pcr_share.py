"""The wide PCR kernel's sharing rule (``ops.interval1d.shares_env0_factors``):
an env whose β row equals env 0's bit for bit takes env 0's factor rows. Its
plain form on the CPU, and why bit equality is the safe test: rows equal in
every bit give factors equal in every bit, and rows that differ in a bit (the
sign of a zero, a NaN payload) are never shared, even where their factors
would agree.
"""

import numpy as np
import pytest
import torch

from pdecontrolgym_tpu_torch.ops.interval1d import (
    ReactionDiffusionImplicitBody,
    shares_env0_factors,
)

from torch_parity import chebyshev_beta_np

N = 600


def _rows(batch=6):
    beta = np.tile(chebyshev_beta_np(N), (batch, 1))
    beta[:, 7] = 0.0
    return beta


def _nan(payload):
    return np.array([0x7FC00000 | payload], np.uint32).view(np.float32)[0]


@pytest.mark.parametrize("case", ["equal", "negative_zero", "nan_payloads", "spread"])
def test_the_rule_is_bit_equality_with_env_0(case):
    beta = _rows()
    want = [True] * 6
    if case == "negative_zero":
        beta[3, 7] = -0.0  # env 0 holds +0 there
        want[3] = False
    elif case == "nan_payloads":
        beta[:, 11] = _nan(5)  # the same NaN in every row: shared
        beta[4, 11] = _nan(6)  # another payload: not shared
        want[4] = False
    elif case == "spread":
        beta[1::2] += np.float32(1e-3)
        want = [True, False, True, False, True, False]
    got = shares_env0_factors(torch.from_numpy(beta))
    assert got.dtype == torch.bool and got.tolist() == want
    # the rule never mistakes a row for env 0's
    bits = beta.view(np.uint32)
    assert got.tolist() == [bool((bits[b] == bits[0]).all()) for b in range(6)]


def test_shared_rows_have_env_0s_factors_to_the_bit():
    """What sharing relies on: the factor rows, 1/b and eb are functions of the
    β row and the spec alone, so rows equal in every bit (a NaN row included)
    give factors equal in every bit. Rows of −0 and +0 would give the same
    factors too; the rule still does not share them."""
    beta = _rows(4)
    beta[:, 11] = _nan(5)
    beta[2, 7] = -0.0
    body = ReactionDiffusionImplicitBody(4e-4, 1.0 / (N - 1), 0.5, False)
    factors, inv_b, eb = body.prepare(torch.from_numpy(beta))
    flags = shares_env0_factors(torch.from_numpy(beta))
    assert flags.tolist() == [True, True, False, True]
    arrays = [f for _, alpha, beta_k in factors for f in (alpha, beta_k)] + [inv_b, eb]
    for b in range(4):
        same = all(torch.equal(a[b].view(torch.int32), a[0].view(torch.int32)) for a in arrays)
        assert same  # equal factors where shared, and here also where not
