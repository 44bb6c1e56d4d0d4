"""The traffic generator: the same work for every seed, in another
order."""
import json

import numpy as np
import pytest

import traffic
from conftest import BENCH


def _mix(name):
    return json.loads((BENCH / "traffic" / f"{name}.json").read_text())


@pytest.mark.parametrize("name", ["conv-poisson", "code-poisson",
                                  "decode-closed"])
def test_every_seed_draws_the_same_lengths(name):
    mix = _mix(name)
    blocks = []
    for seed in (1, 2 ** 31 + 11):
        tr = traffic.Traffic(mix, seed, 1000)
        blocks.append([tr.lengths() for _ in range(traffic.BLOCK)])
    assert blocks[0] != blocks[1]                   # another order
    for i in (0, 1):                                # the same multiset
        assert sorted(x[i] for x in blocks[0]) == sorted(
            x[i] for x in blocks[1])
    ins = [x[0] for x in blocks[0]]
    outs = [x[1] for x in blocks[0]]
    assert mix["min_in"] <= min(ins) and max(ins) <= mix["max_in"]
    assert mix["min_out"] <= min(outs) and max(outs) <= mix["max_out"]
    # the strata's mean is the clipped log-normal's (the port's sampler)
    rng = np.random.default_rng(0)
    for got, key, sigma in ((ins, "in", 1.0), (outs, "out", 0.6)):
        mu = np.log(mix[f"mean_{key}"]) - sigma ** 2 / 2
        want = np.clip(rng.lognormal(mu, sigma, 400_000).astype(int),
                       mix[f"min_{key}"], mix[f"max_{key}"]).mean()
        assert abs(np.mean(got) / want - 1) < 0.02


@pytest.mark.parametrize("name", ["conv-poisson", "code-poisson"])
def test_every_seed_gets_the_same_window(name):
    mix = dict(_mix(name), rate=2.2)
    plans = [traffic.Traffic(mix, seed, 10).schedule(20.0, 50.0)
             for seed in (3, 2 ** 33 + 4)]
    windows = [[p for p in plan if p[0] >= 20.0] for plan in plans]
    assert len(windows[0]) == len(windows[1]) == 110
    assert len(plans[0]) == 110 + 44
    for w in windows:
        times = [p[0] for p in w]
        assert times[0] == 20.0 and times[-1] < 70.0
        assert all(b > a for a, b in zip(times, times[1:]))
    assert windows[0] != windows[1]
    for i in (1, 2):
        assert sorted(p[i] for p in windows[0]) == sorted(
            p[i] for p in windows[1])
    gaps = [sorted(np.diff([p[0] for p in w] + [70.0])) for w in windows]
    assert np.allclose(gaps[0], gaps[1])


def test_tokens_lie_in_the_vocabulary():
    tr = traffic.Traffic(_mix("conv-poisson"), 5, 37)
    for n in (1, 50, 4000):
        tokens = tr.tokens(n)
        assert tokens.dtype == np.int32 and len(tokens) == n
        assert tokens.min() >= 0 and tokens.max() < 37


def test_closed_loop_starts_in_flight():
    mix = _mix("decode-closed")
    start = traffic.Traffic(mix, 6, 100).steady_start(mix["clients"])
    assert len(start) == mix["clients"]
    assert all(out >= 1 for _, out in start)
    # a share of each output is already folded into its prompt
    assert max(len(t) for t, _ in start) > mix["max_in"] // 4


ARRIVAL_MIXES = {
    "poisson": {"rate": 2.2},
    "burst": {"rate": 2.2, "burstiness": 4.0, "mean_on_s": 2.5},
    "ramp": {"rate_lo": 0.5, "rate_hi": 3.9, "period_s": 35.0},
}


@pytest.mark.parametrize("kind", sorted(ARRIVAL_MIXES))
def test_every_arrival_gives_each_seed_the_same_window(kind):
    mix = {**_mix("conv-poisson"), "arrival": kind, **ARRIVAL_MIXES[kind]}
    windows = []
    for seed in (3, 2 ** 33 + 4):
        plan = traffic.Traffic(mix, seed, 10).schedule(20.0, 50.0)
        times = [p[0] for p in plan]
        assert times[0] == 0.0 and times[-1] < 70.0
        assert all(b > a for a, b in zip(times, times[1:]))
        windows.append([p for p in plan if p[0] >= 20.0])
    assert len(windows[0]) == len(windows[1])
    if kind != "ramp":
        assert len(windows[0]) == 110                   # 2.2/s, 50 s
    for i in (1, 2):
        assert sorted(p[i] for p in windows[0]) == sorted(
            p[i] for p in windows[1])


def test_burst_arrivals_come_in_on_phases():
    mix = {**_mix("conv-poisson"), "arrival": "burst",
           **ARRIVAL_MIXES["burst"]}
    poisson = {**mix, "arrival": "poisson"}
    gaps = []
    for m in (mix, poisson):
        times = [p[0] for p in traffic.Traffic(m, 8, 10).schedule(
            20.0, 50.0) if p[0] >= 20.0]
        gaps.append(np.sort(np.diff(times)))
    # the same mean rate, but long silences and crowded on phases
    assert gaps[0][-1] > 3 * gaps[1][-1]
    assert np.median(gaps[0]) < 0.5 * np.median(gaps[1])


def test_ramp_arrivals_follow_the_rate():
    mix = {**_mix("conv-poisson"), "arrival": "ramp",
           **ARRIVAL_MIXES["ramp"], "period_s": 40.0}
    times = np.array([p[0] for p in traffic.Traffic(mix, 9, 10).schedule(
        20.0, 60.0)])
    # trough at 0 and 40 s (0.5/s), crest at 20 and 60 s (3.9/s)
    trough = np.sum((times >= 35.0) & (times < 45.0))
    crest = np.sum((times >= 55.0) & (times < 65.0))
    assert crest > 3 * trough


@pytest.mark.parametrize("bad", [{"arrival": "uniform"}, {"loop": "ring"}])
def test_an_unknown_arrival_or_loop_is_refused(bad):
    mix = {**_mix("conv-poisson"), **bad}
    with pytest.raises(ValueError):
        traffic.Traffic(mix, 1, 10).schedule(20.0, 50.0)
