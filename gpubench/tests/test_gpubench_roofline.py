"""The SPD factor-and-solve's roofline count at the shapes the ineq cells
send it (PERF.md's launch counts at config 4: (256, 110, 1), (64, 110, 1),
(64, 110, 110), (256, 110, 110), (256, 110, 100))."""

import types

import pytest
import torch

from gpubench import core, peaks

SHAPES = [(256, 110, 1), (64, 110, 1), (64, 110, 110), (256, 110, 110),
          (256, 110, 100)]


@pytest.mark.parametrize("B,n,K", SHAPES)
def test_chol_bound_counts(B, n, K):
    flops = B * (n**3 / 3 + 2 * n * n * K)
    nbytes = 4 * B * (n * (n + 1) // 2 + 2 * n * K)
    ms, what = peaks.chol_bound(B, n, K)
    want = 1e3 * max(flops / 67e12, nbytes / 3.35e12)
    assert ms == pytest.approx(want, rel=1e-12)
    assert what == ("operations" if flops / 67e12 >= nbytes / 3.35e12
                    else "bytes")
    # float64 words: twice the bytes, the card's higher float64 rate
    ms8, _ = peaks.chol_bound(B, n, K, word=8)
    assert ms8 == pytest.approx(1e3 * max(flops / 67e12, 2 * nbytes / 3.35e12),
                                rel=1e-12)


def test_spd_reader_takes_each_call_shape(bench):
    mod = core.load_module(core.HERE / "metrics" / "spd_roofline_pct.py")
    sp = mod.SPANS[0]
    A = torch.zeros(64, 110, 110)
    assert sp.record((A, torch.zeros(64, 110)), {}) == (64, 110, 1, 4)
    assert sp.record((A.double(), torch.zeros(64, 110, 7).double()), {}) \
        == (64, 110, 7, 8)
    calls = [(256, 110, 1, 4), (64, 110, 110, 4)]
    least_s = sum(peaks.chol_bound(*c)[0] for c in calls) / 1e3
    t = types.SimpleNamespace(calls={"spd": calls},
                              device_s={"spd": 4 * least_s})
    assert mod.read(types.SimpleNamespace(trace=t)) == pytest.approx(25.0)
    # nothing traced: the metric is left out, never 0
    t0 = types.SimpleNamespace(calls={}, device_s={})
    assert mod.read(types.SimpleNamespace(trace=t0)) is None
