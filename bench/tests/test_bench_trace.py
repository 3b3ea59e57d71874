"""Reading a traced slice: busy time and time by kernel come out the same
whichever of the two marker kernels the profiler recorded (it does not
always record both), and the idle gaps land on the host's clock."""
import pytest

from bench.trace import MARKER, DeviceSlice

OFF = 1.7e9              # the profiler's clock less the host's
WORK = [("gemm", 10.10, 10.40), ("attn", 10.30, 10.60),
        ("gemm", 10.80, 10.90)]


def _slice(markers):
    sl = DeviceSlice(cuda=True)
    sl._marks = [9.999, 11.0005]          # host times of the two markers
    sl.t0, sl.t1 = 10.0, 11.0
    evs = [(n, s + OFF, e + OFF) for n, s, e in WORK]
    ends = {"start": (9.999, 10.0), "end": (11.0005, 11.0015)}
    evs += [(MARKER + "(long)", ends[m][0] + OFF, ends[m][1] + OFF)
            for m in markers]
    sl.read(evs)
    return sl


@pytest.mark.parametrize("markers", [("start", "end"), ("start",),
                                     ("end",), ()])
def test_busy_time_whichever_markers_were_recorded(markers):
    sl = _slice(markers)
    assert sl.markers == len(markers)
    assert sl.window_s == pytest.approx(1.0)
    assert sl.busy_s == pytest.approx(0.6)
    assert sl.by_name == {"gemm": pytest.approx(0.4),
                          "attn": pytest.approx(0.3)}
    if markers:
        assert sl.gaps == [pytest.approx(g) for g in
                           [(10.0, 10.1), (10.6, 10.8), (10.9, 11.0)]]
    got = sl.idle_by_phase([("decode_launch", 10.55, 10.85)])
    assert sum(v for _, v in got) == pytest.approx(0.4)
