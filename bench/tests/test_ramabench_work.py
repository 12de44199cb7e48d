"""The roofline arithmetic on hand-counted inputs, and the reduction of a
profiler trace on hand-made events."""
import math
import sys
from pathlib import Path

import numpy as np
import pytest

BENCH = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(BENCH))

from ramabench import profiling, work  # noqa: E402


def test_triangle_mp_phase_by_hand():
    # T = 3 rows, 2 valid: slots (0, 1, 2) and (2, 3, 4); edge 2 twice
    tri = np.array([[0, 1, 2], [2, 3, 4], [7, 8, 9]], dtype=np.int32)
    valid = np.array([True, True, False])
    ops, nbytes = work.triangle_mp_phase(tri, valid, iters=5)
    nv, U, sq = 2, 5, 1 + 1 + 4 + 1 + 1      # segments 1,1,2,1,1
    assert ops == 5 * (sq + 9 * nv + 50 * nv) + 6 + U
    assert nbytes == 3 + 12 * nv + 36 * nv + 4 * U + 12 * nv + 4 * U


def test_cycle_intersect_by_hand():
    ops, nbytes = work.cycle_intersect(32, 128, 128)
    assert ops == 2 * 32 * 128 * 8           # ceil(log2(129)) = 8
    assert nbytes == 4 * (2 * 32 * 128 + 32 * 128)
    assert work.cycle_intersect(1, 1, 1) == (2, 12)


def test_contraction_and_min_seconds_by_hand():
    assert work.contraction(10, 4, 6, 3) == 140 + 20 + 174 + 12
    bw = work.PEAKS["hbm_bytes_per_s"]
    assert work.min_seconds(0, 3.35e12, "fp32_ops_per_s") == \
        pytest.approx(3.35e12 / bw)
    assert work.min_seconds(67e12, 1, "fp32_ops_per_s") == pytest.approx(1)


def events():
    ms = 1_000_000
    ranges = {"bench.window": [(0, 100 * ms)],
              "repro.separation": [(10 * ms, 20 * ms), (60 * ms, 70 * ms)],
              "repro.contraction": [(20 * ms, 50 * ms)],
              "bench.solve": [(5 * ms, 95 * ms)]}
    # (start, end, name, correlation); launches by correlation
    device = [(12 * ms, 14 * ms, "sep_k", 1), (13 * ms, 15 * ms, "sep_k", 2),
              (25 * ms, 55 * ms, "scatter", 3), (61 * ms, 62 * ms, "sep_k", 4),
              (96 * ms, 120 * ms, "late", 5), (-5 * ms, 1 * ms, "early", 6)]
    launches = {1: 11 * ms, 2: 12 * ms, 3: 21 * ms, 4: 60.5 * ms,
                5: 94 * ms}
    return device, ranges, launches


def test_reduce_events_by_hand():
    out = profiling.reduce_events(*events())
    s = 1e-3
    assert out["window_s"] == pytest.approx(100 * s)
    # union: [0,1] [12,15] [25,55] [61,62] [96,100] = 1+3+30+1+4 ms
    assert out["busy_s"] == pytest.approx(39 * s)
    ph = out["phases"]
    assert ph["repro.separation"]["busy_s"] == pytest.approx(5 * s)
    assert ph["repro.separation"]["host_s"] == pytest.approx(20 * s)
    assert ph["repro.separation"]["count"] == 2
    assert ph["repro.contraction"]["busy_s"] == pytest.approx(30 * s)
    assert ph["bench.solve"]["busy_s"] == pytest.approx(4 * s)
    assert out["unmatched_launches"] == 1          # "early" has no launch
    assert out["device_ops"][0] == ["scatter", pytest.approx(30 * s)]
    # idle [1,12] before any range, [15,25] and [62,96] in separation,
    # [55,61] in bench.solve alone
    assert dict(out["idle_gaps"]) == {
        "host outside the ranges": pytest.approx(11 * s),
        "repro.separation": pytest.approx(44 * s),
        "bench.solve": pytest.approx(6 * s)}


def test_roofline_share_is_none_without_time():
    from ramabench.readers import roofline_pct
    assert roofline_pct(1.0, 0.0) is None
    assert roofline_pct(0.0, 1.0) is None
    assert roofline_pct(1.0, 4.0) == 25.0
    assert not math.isnan(roofline_pct(2.0, 4.0))
