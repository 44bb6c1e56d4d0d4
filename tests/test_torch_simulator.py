"""The port's paper-table helpers (``compare_all``, ``utilization_table``
and the standalone throughputs under them) against the JAX package's, key
for key, on the same ~60-request traces; NaN equals NaN."""
import math

import pytest

from repro.configs import get_config as jax_get_config
from repro.serving import hardware as jax_hw
from repro.serving import simulator as jax_sim
from repro.serving.trace import make_trace as jax_make_trace
from repro_torch.configs import get_config
from repro_torch.serving import hardware, simulator
from repro_torch.serving.trace import make_trace

N_REQUESTS = 60


def _same(a, b) -> bool:
    if isinstance(a, dict):
        return isinstance(b, dict) and a.keys() == b.keys() and all(
            _same(a[k], b[k]) for k in a)
    if isinstance(a, float) and isinstance(b, float) and math.isnan(a):
        return math.isnan(b)
    return a == b


def _traces(seed, interval):
    return (make_trace(N_REQUESTS, seed=seed, interval=interval),
            jax_make_trace(N_REQUESTS, seed=seed, interval=interval))


@pytest.mark.parametrize("seed,interval", [(0, 0.0), (1, 0.1)],
                         ids=["maxtput", "interval"])
def test_compare_all_matches_jax(seed, interval):
    reqs, jreqs = _traces(seed, interval)
    got = simulator.compare_all(get_config("llama3-8b"), hardware.A100,
                                hardware.A10, reqs)
    want = jax_sim.compare_all(jax_get_config("llama3-8b"), jax_hw.A100,
                               jax_hw.A10, jreqs)
    assert set(got) == set(simulator.APPROACHES)
    assert _same(got, want)


def test_utilization_table_matches_jax():
    reqs, jreqs = _traces(0, 0.0)
    got = simulator.utilization_table(get_config("llama3-8b"),
                                      hardware.A100, hardware.A10, reqs)
    want = jax_sim.utilization_table(jax_get_config("llama3-8b"),
                                     jax_hw.A100, jax_hw.A10, jreqs)
    assert set(got) == {"disagg_hl", "disagg_lh"}
    assert _same(got, want)


@pytest.mark.parametrize("spec", ["A100", "A10"])
def test_standalone_throughputs_match_jax(spec):
    reqs, jreqs = _traces(2, 0.0)
    dev = hardware.DeviceModel(getattr(hardware, spec),
                               get_config("llama3-8b"))
    jdev = jax_hw.DeviceModel(getattr(jax_hw, spec),
                              jax_get_config("llama3-8b"))
    assert (simulator.max_prefill_throughput(dev, reqs)
            == jax_sim.max_prefill_throughput(jdev, jreqs))
    assert (simulator.max_decode_throughput(dev, reqs)
            == jax_sim.max_decode_throughput(jdev, jreqs))
