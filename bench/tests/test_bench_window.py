"""The window's arithmetic: rates over the window, nearest-rank tails with
failed requests counted as missing."""
import math
import types

import pytest

from bench import core
from bench.drivers import serve_open_loop as sol

W0, W1 = 0.0, 10.0


def _rec(rid, due, stamps, failed=False):
    r = sol.Rec(types.SimpleNamespace(due_s=due, rid=rid), 10, 5)
    r.stamps = list(stamps)
    r.first_t = stamps[0][0] if stamps else None
    r.failed = failed
    r.done_t = stamps[-1][0] if stamps else (W1 if failed else None)
    return r


def _ctx(recs):
    snap = {"decode_steps": 0, "gen_tokens": 0, "prefill_tokens": 0,
            "prefix_hit_tokens": 0, "prefill_forwards": 0}
    ctx = sol._window_ctx(recs, W0, W1, snap, snap, None)
    ctx.update(window_s=W1 - W0, follow_ms=70e3)
    return ctx


def _steady(shift_after=None, by=0.0):
    recs = []
    for i in range(20):
        stamps = []
        for k in range(1, 11):
            t = 0.4 * i + 0.05 * k
            if shift_after is not None and t > shift_after:
                t += by
            stamps.append((t, 1))
        recs.append(_rec(i, 0.4 * i, stamps))
    return recs


def test_a_stall_inside_the_window_shows_in_the_tails():
    base, stalled = _ctx(_steady()), _ctx(_steady(shift_after=5.0, by=2.0))
    assert base["window_tokens"] == 200
    assert stalled["window_tokens"] < base["window_tokens"]
    tpot = core.metric_reader("tpot_p95_ms")
    assert tpot(base) == pytest.approx(50.0)
    assert tpot(stalled) > tpot(base)
    ttft = core.metric_reader("ttft_p95_ms.serve")
    assert ttft(stalled) > ttft(base)


@pytest.mark.parametrize("n_failed,finite", [(0, True), (1, True),
                                             (2, False)])
def test_p95_counts_failed_requests_as_missing(n_failed, finite):
    recs = [_rec(i, 0.4 * i, [(0.4 * i + 0.1 + 0.001 * i, 3)])
            for i in range(20 - n_failed)]
    recs += [_rec(100 + j, 1.0 + j, [], failed=True)
             for j in range(n_failed)]
    ctx = _ctx(recs)
    assert ctx["attempted"] == 20 and ctx["failed"] == n_failed
    v = core.nearest_rank(ctx["ttft_ms"], 0.95)
    assert math.isfinite(v) == finite
    got = core.metric_reader("ttft_p95_ms.serve")(ctx)
    # nearest rank: the 19th of 20 sorted times; a miss there reads as
    # the longest a request was followed
    assert got == (pytest.approx(100 + 0.001 * 18 * 1e3) if finite
                   else 70e3)


def test_nearest_rank_small_cases():
    assert core.nearest_rank([3, 1, 2], 0.5) == 2
    assert core.nearest_rank([1, None], 0.5) == 1
    assert core.nearest_rank([1, None], 0.95) == math.inf
    assert math.isnan(core.nearest_rank([], 0.95))


def test_tpot_is_mean_gap_over_window_tokens():
    r = _rec(0, 0.0, [(1.0, 1), (1.5, 2), (3.0, 1), (11.0, 5)])
    ctx = _ctx([r])
    # window tokens: 4, stamped 1.0 .. 3.0: (3.0 - 1.0) / 3 gaps
    assert ctx["tpot_ms"] == [pytest.approx(2000 / 3)]
    assert ctx["window_tokens"] == 4
