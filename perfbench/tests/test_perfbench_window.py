"""The window arithmetic: a rate over the whole window, the 95th
percentile over every step, and a stall that moves both."""

import pytest

from harness.window import percentile, rate, run_window


class Clock:
    """A host clock that a step moves by its own duration."""

    def __init__(self):
        self.t = 100.0

    def __call__(self):
        return self.t


def _loop(durations, seconds):
    clock = Clock()
    it = iter(durations)

    def step():
        clock.t += next(it)
        return {"queries": 10, "answered": 10}
    return run_window(step, seconds, clock=clock)


def test_window_ends_with_the_step_that_crosses():
    win = _loop([0.3] * 10, 1.0)
    assert len(win.records) == 4            # 0.9 s < 1.0 <= 1.2 s
    assert win.seconds == pytest.approx(1.2)
    assert [r["latency_s"] for r in win.records] == pytest.approx([0.3] * 4)


def test_rate_is_over_all_the_window():
    win = _loop([0.1] * 20, 1.0)
    assert rate(win.total("answered"), win.seconds) == pytest.approx(
        win.total("answered") / win.seconds)
    assert rate(100, 2.0) == 50.0
    with pytest.raises(ValueError):
        rate(1, 0.0)


def test_p95_is_over_every_step():
    vals = list(range(1, 101))               # 1..100
    assert percentile(vals, 95) == 95
    assert percentile([5.0], 95) == 5.0
    assert percentile([3, 1, 2], 50) == 2    # nearest rank, any order
    with pytest.raises(ValueError):
        percentile([], 95)


@pytest.mark.parametrize("stall", [0.5, 2.0])
def test_a_stall_moves_rate_and_tail(stall):
    steady = _loop([0.01] * 400, 2.0)
    # The same steps with one in ten stalled.
    durs = [0.01 + (stall * 0.01 if i % 10 == 9 else 0.0) for i in range(400)]
    stalled = _loop(durs, 2.0)
    q_s = rate(steady.total("answered"), steady.seconds)
    q_t = rate(stalled.total("answered"), stalled.seconds)
    p_s = percentile(steady.latencies(), 95)
    p_t = percentile(stalled.latencies(), 95)
    assert q_t < q_s
    assert p_t > p_s
    assert p_t == pytest.approx(0.01 * (1 + stall))
