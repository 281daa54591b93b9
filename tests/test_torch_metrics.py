"""Port parity for the metrics registry: ``repro_torch.obs`` fed the same
operations as ``repro.obs`` snapshots identically (the same schema,
series, buckets and quantiles), enabled and disabled; the tuner's cache
counts its hits and misses into the port's default registry."""
import json
import math

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.obs.metrics as ref_metrics
import repro_torch.obs as port_obs
import repro_torch.obs.metrics as port_metrics


def _feed(reg, seed):
    rng = np.random.default_rng(seed)
    for i in range(200):
        reg.counter("serve.requests.finished").inc(int(rng.integers(1, 4)))
        reg.gauge("serve.queue.depth").set(float(rng.integers(0, 9)))
        v = float(rng.lognormal(1.0, 1.5))
        reg.histogram("serve.step_ms").observe(v if i % 17 else 0.0)
        reg.histogram("tune.drift.time_ratio").observe(
            float(rng.uniform(-1.0, 3.0)))
    reg.counter("power.faults")
    return reg


@pytest.mark.parametrize("seed", [0, 1, 7])
def test_snapshots_equal_reference(seed):
    mine = _feed(port_metrics.MetricsRegistry(), seed).snapshot()
    ref = _feed(ref_metrics.MetricsRegistry(), seed).snapshot()
    assert json.dumps(mine, sort_keys=True) == json.dumps(ref, sort_keys=True)
    assert mine["kind"] == "repro-obs-metrics"
    assert mine["schema_version"] == ref_metrics.SCHEMA_VERSION


def test_disabled_registry_is_empty_and_null():
    for pkg in (port_metrics, ref_metrics):
        reg = pkg.MetricsRegistry(enabled=False)
        _feed(reg, 0)
        assert reg.snapshot()["series"] == {}
    assert port_obs.null_registry().snapshot()["series"] == {}
    assert port_obs.default_registry() is port_obs.default_registry()


@pytest.mark.parametrize("q", [0.0, 0.25, 0.5, 0.95, 0.99, 1.0])
def test_histogram_quantiles_and_merge_equal_reference(q):
    def build(pkg):
        a, b = pkg.Histogram("a"), pkg.Histogram("b")
        for i in range(1, 60):
            a.observe(math.sqrt(i))
            b.observe(i * 0.37)
        return a.merge(b)

    mine, ref = build(port_metrics), build(ref_metrics)
    assert mine.quantile(q) == ref.quantile(q)
    assert mine.to_dict() == ref.to_dict()


def test_kind_mismatch_raises_as_reference():
    for pkg in (port_metrics, ref_metrics):
        reg = pkg.MetricsRegistry()
        reg.counter("x")
        with pytest.raises(TypeError, match="already registered"):
            reg.gauge("x")


def test_tune_cache_counts_hits_and_misses(tmp_path):
    from repro_torch.tune import TuneCache

    reg = port_obs.default_registry()
    before = {k: reg.counter(k).value
              for k in ("tune.cache.miss.mm", "tune.cache.hit.mm")}
    cache = TuneCache(str(tmp_path / "t.json"))
    assert cache.get("mm/128x128x128/float32/cpu") is None
    cache.put("mm/128x128x128/float32/cpu", {"config": {}})
    assert cache.get("mm/128x128x128/float32/cpu") == {"config": {}}
    assert reg.counter("tune.cache.miss.mm").value == \
        before["tune.cache.miss.mm"] + 1
    assert reg.counter("tune.cache.hit.mm").value == \
        before["tune.cache.hit.mm"] + 1
