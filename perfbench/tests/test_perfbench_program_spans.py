"""The readers of the port's own spans on a synthetic session and device
trace whose values are worked out by hand: the CPI decode's phases, and
the card's idle time split by overlap, the innermost span or phase taking
each idle instant.

Times are nanoseconds on the perf clock; the session maps them onto the
device's epoch clock by adding ``E``. Three ticks lie in the window
(0 to 1950 ns), a fourth CPI decode ends after it and is left out:

    tick [100, 1000]    step cpi [150, 950]     decode cpi [200, 800]:
                        submit [960, 990]       prep 200, launch 300,
                                                readback 600, pick 700
    tick [1050, 1500]   step ppi [1100, 1480]   decode ppi [1200, 1400]:
                                                prep 1200, launch 1250
    tick [1550, 1900]   step cpi [1560, 1890]   decode cpi [1600, 1880]:
                                                prep 1600, launch 1610,
                                                readback 1800, pick 1850
    decode cpi [1960, 2100], after the window

The device runs [0, 120], [250, 350], [500, 650], [900, 1050],
[1300, 1320] and [1700, 1750]. Idle in a launch phase: 150 (300-600
less 300-350 and 500-600) + 130 (1250-1400 less 20) + 140 (1610-1800 less
50) = 420 ns. Idle elsewhere in the spans: 30 + 50 + 50 + 50 + 100 + 100
(first tick: tick, step, prep, readback, pick, step) + 50 + 100 + 50 + 80
+ 20 (second) + 10 + 40 + 10 + 50 + 30 + 10 + 10 (third) = 840 ns. Over a
profiled window of 2000 ns: 21% and 42%.
"""
import sys

import pytest

import harness
from repro_torch.obs import host

E = 10 ** 15
WINDOW_S = 2000e-9


def _span(sess, name, t0, t1, parent=-1, marks=(), **args):
    sp = host.Span(sess, name, None)
    sp.t0, sp.t1, sp.parent = t0, t1, parent
    sp.marks, sp.args = list(marks), args
    sess.spans.append(sp)
    return len(sess.spans) - 1


def _decode(sess, parent, engine, t0, t1, *marks):
    names = ["prep", "launch", "readback", "pick"][:len(marks)]
    return _span(sess, "executor.decode", t0, t1, parent,
                 list(zip(names, marks)), engine=engine, lanes=1,
                 reqs=["r0"])


def _session():
    sess = host.Session()
    sess.epoch_ns, sess.perf_ns = E, 0
    t = _span(sess, "runtime.tick", 100, 1000)
    s = _span(sess, "engine.step", 150, 950, t, engine="cpi")
    _decode(sess, s, "cpi", 200, 800, 200, 300, 600, 700)
    _span(sess, "pair.submit", 960, 990, t, req="r1", l_p=8)
    t = _span(sess, "runtime.tick", 1050, 1500)
    s = _span(sess, "engine.step", 1100, 1480, t, engine="ppi")
    _decode(sess, s, "ppi", 1200, 1400, 1200, 1250)
    t = _span(sess, "runtime.tick", 1550, 1900)
    s = _span(sess, "engine.step", 1560, 1890, t, engine="cpi")
    _decode(sess, s, "cpi", 1600, 1880, 1600, 1610, 1800, 1850)
    t = _span(sess, "runtime.tick", 1955, 2110)
    s = _span(sess, "engine.step", 1958, 2105, t, engine="cpi")
    _decode(sess, s, "cpi", 1960, 2100, 1960, 1970)
    return sess


def _trace():
    busy = [(0, 120), (250, 350), (500, 650), (900, 1050), (1300, 1320),
            (1700, 1750)]
    return {"events": [("k", E + a, E + b) for a, b in busy],
            "window_s": WINDOW_S, "busy_s": 0.0}


def _run(trace=True):
    return harness.Run({}, [], 0.0, 1950e-9, harness.Record(),
                       _trace() if trace else None)


@pytest.fixture
def session(monkeypatch):
    sess = _session()
    monkeypatch.setattr(host, "session", lambda: sess)
    return sess


@pytest.mark.parametrize("metric,want", [
    ("decode_launch_ms.lat", 1e-6 * (300 + 190) / 2),
    ("decode_host_ms.lat", 1e-6 * ((100 + 100) + (10 + 30)) / 2),
    ("idle_in_launch.lat", 21.0), ("idle_in_launch.sat", 21.0),
    ("idle_in_host_work.lat", 42.0), ("idle_in_host_work.sat", 42.0)])
def test_readers_read_the_hand_worked_values(session, metric, want):
    assert harness.reader(metric)(_run()) == pytest.approx(want)


@pytest.mark.parametrize("metric", ["decode_launch_ms.lat",
                                    "decode_host_ms.lat"])
def test_span_readers_need_no_device_trace(session, metric):
    assert harness.reader(metric)(_run(trace=False)) > 0


@pytest.mark.parametrize("metric", ["idle_in_launch.lat",
                                    "idle_in_host_work.sat"])
def test_device_readers_return_none_without_a_device_trace(session, metric):
    assert harness.reader(metric)(_run(trace=False)) is None


METRICS = ["decode_launch_ms.lat", "decode_host_ms.lat",
           "idle_in_launch.lat", "idle_in_host_work.lat"]


@pytest.mark.parametrize("metric", METRICS)
def test_readers_return_none_without_a_session(monkeypatch, metric):
    monkeypatch.setattr(host, "session", lambda: None)
    assert harness.reader(metric)(_run()) is None


@pytest.mark.parametrize("metric", METRICS)
def test_readers_return_none_on_a_port_without_the_recorder(monkeypatch,
                                                            metric):
    monkeypatch.setitem(sys.modules, "repro_torch.obs", None)
    assert harness.reader(metric)(_run()) is None


def test_decode_readers_see_only_the_cpi(monkeypatch):
    sess = host.Session()
    sess.epoch_ns, sess.perf_ns = E, 0
    _decode(sess, -1, "ppi", 200, 800, 200, 300, 600, 700)
    monkeypatch.setattr(host, "session", lambda: sess)
    assert harness.reader("decode_launch_ms.lat")(_run()) is None


def test_innermost_span_or_phase_takes_each_instant(session):
    import program_spans
    spans = program_spans.window_spans(_run())[1]
    segs = program_spans.segments(session, spans)
    got = [(a, b, sp.name, name) for a, b, sp, name in segs][:10]
    assert got == [
        (100, 150, "runtime.tick", None), (150, 200, "engine.step", None),
        (200, 300, "executor.decode", "prep"),
        (300, 600, "executor.decode", "launch"),
        (600, 700, "executor.decode", "readback"),
        (700, 800, "executor.decode", "pick"),
        (800, 950, "engine.step", None), (950, 960, "runtime.tick", None),
        (960, 990, "pair.submit", None), (990, 1000, "runtime.tick", None)]
    # the window's spans are covered once, and nothing outside them
    covered = sum(b - a for a, b, _, _ in segs)
    assert covered == (1000 - 100) + (1500 - 1050) + (1900 - 1550)
