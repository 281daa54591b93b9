"""Port parity for energy telemetry: ``repro_torch.power`` against
``repro.power``.

* ``RaplBackend`` over the reference test's fake powercap tree (two
  packages, one dram subzone), wraparound included: the same domains and
  joules as the reference's backend.
* ``NvmlBackend`` over a fake NVML library (the five entry points the
  port binds with ``ctypes``): the cumulative counter path, the
  power-integration path, a counter that fails mid-run, and a missing
  library, where the constructor raises and ``available()`` is False.
* ``EnergyMeter``: nesting, the decorator, and the start-failed
  sentinel (zero joules, a ``power.faults`` count), as the reference.
* ``EnergyReport.to_dict()`` passes both packages' ``validate_report``;
  ``ModelBackend`` under the reference's constants reads the reference's
  joules for the same hints and time.
"""
import ctypes
import dataclasses
import json
import os

import pytest
torch = pytest.importorskip("torch")

import repro.core.energy as ref_energy
import repro.power as ref_power
import repro_torch.power as port_power
from repro_torch.core.energy import HW
from repro_torch.obs import default_registry

DRAM_MAX_UJ = 65_712_999_613
REF_HW = HW(**dataclasses.asdict(ref_energy.TPU_V5E))


def _write_zone(root, zone, label, uj, max_uj=262_143_328_850):
    d = os.path.join(root, zone)
    os.makedirs(d, exist_ok=True)
    with open(os.path.join(d, "name"), "w") as f:
        f.write(label + "\n")
    with open(os.path.join(d, "energy_uj"), "w") as f:
        f.write(f"{uj}\n")
    with open(os.path.join(d, "max_energy_range_uj"), "w") as f:
        f.write(f"{max_uj}\n")
    return d


@pytest.fixture
def rapl_root(tmp_path):
    root = str(tmp_path / "powercap")
    _write_zone(root, "intel-rapl:0", "package-0", 1_000_000)
    _write_zone(root, "intel-rapl:0:0", "dram", 500_000, DRAM_MAX_UJ)
    _write_zone(root, "intel-rapl:1", "package-1", 42_000)
    return root


# ---------------------------------------------------------------------- RAPL
@pytest.mark.parametrize("wrap", [False, True])
def test_rapl_equals_reference(rapl_root, wrap):
    mine, ref = port_power.RaplBackend(rapl_root), \
        ref_power.RaplBackend(rapl_root)
    assert mine._domains == ref._domains
    assert mine.primary_domains == ref.primary_domains == \
        ("package-0", "package-1")
    t_mine, t_ref = mine.start(), ref.start()
    _write_zone(rapl_root, "intel-rapl:0", "package-0", 3_000_000)
    _write_zone(rapl_root, "intel-rapl:0:0", "dram",
                100 if wrap else 900_000, DRAM_MAX_UJ)
    a, b = mine.stop(t_mine, 0.1), ref.stop(t_ref, 0.1)
    assert a == b
    assert a["package-0"] == pytest.approx(2.0)
    assert a["dram"] == pytest.approx(
        (DRAM_MAX_UJ - 500_000 + 100) * 1e-6 if wrap else 0.4)


def test_rapl_meter_and_detection_equal_reference(rapl_root, tmp_path):
    b = port_power.RaplBackend(rapl_root)
    with port_power.EnergyMeter("r", backend=b) as em:
        _write_zone(rapl_root, "intel-rapl:0", "package-0", 2_000_000)
    assert em.reading.joules == pytest.approx(1.0)   # subzones not summed
    assert port_power.detect_backend(rapl_root=rapl_root).name == \
        ref_power.detect_backend(rapl_root=rapl_root).name == "rapl"
    assert not port_power.RaplBackend.available(str(tmp_path / "nope"))
    with pytest.raises(RuntimeError):
        port_power.RaplBackend(str(tmp_path / "nope"))


# ---------------------------------------------------------------------- NVML
class FakeNvml:
    """The NVML entry points the port binds, over a scripted counter (mJ)
    and power draw (mW).  ``energy=None`` makes the counter call fail, as
    on a part without it; ``fail_init`` fails initialisation."""

    def __init__(self, energy_mj=(1000,), power_mw=(250_000,),
                 devices=1, fail_init=False):
        self.energy = list(energy_mj) if energy_mj is not None else None
        self.power = list(power_mw)
        self.devices = devices
        self.fail_init = fail_init
        self.calls = 0

    def nvmlInit_v2(self):
        return 1 if self.fail_init else 0

    def nvmlDeviceGetCount_v2(self, count):
        count._obj.value = self.devices
        return 0

    def nvmlDeviceGetHandleByIndex_v2(self, i, handle):
        handle._obj.value = 0x1000 + i
        return 0

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, out):
        self.calls += 1
        if self.energy is None:
            return 3          # NVML_ERROR_NOT_SUPPORTED
        out._obj.value = self.energy.pop(0) if len(self.energy) > 1 \
            else self.energy[0]
        return 0

    def nvmlDeviceGetPowerUsage(self, handle, out):
        out._obj.value = self.power.pop(0) if len(self.power) > 1 \
            else self.power[0]
        return 0


def test_nvml_counter_path():
    lib = FakeNvml(energy_mj=(10_000, 12_500))
    b = port_power.NvmlBackend(lib=lib)
    assert b.name == "nvml" and b.primary_domains == ("gpu0",)
    with port_power.EnergyMeter("k", backend=b) as em:
        pass
    assert em.reading.domains == {"gpu0": pytest.approx(2.5)}
    assert em.reading.joules == pytest.approx(2.5)
    assert em.reading.backend == "nvml"


def test_nvml_power_integration_path():
    """No energy counter: trapezoid of the power draw at both ends."""
    b = port_power.NvmlBackend(lib=FakeNvml(energy_mj=None,
                                            power_mw=(200_000, 300_000)))
    token = b.start()
    assert token == [(None, 200.0)]
    assert b.stop(token, 2.0) == {"gpu0": pytest.approx(500.0)}


def test_nvml_counter_failure_degrades_to_a_missing_domain():
    """Power is read only where the counter is missing: not at a start
    whose counter answered.  A counter that dies mid-run falls back to
    the end's draw; with the power read failing too, the domain is
    missing."""
    lib = FakeNvml(energy_mj=(5000,), power_mw=(100_000,))
    b = port_power.NvmlBackend(lib=lib)
    token = b.start()
    assert token == [(5000, None)] and lib.calls == 1
    lib.energy = None                         # the counter dies mid-run
    assert b.stop(token, 2.0) == {"gpu0": pytest.approx(200.0)}
    lib.nvmlDeviceGetPowerUsage = lambda h, out: 15   # and the power read
    assert b.stop(token, 1.0) == {}


class TickingNvml(FakeNvml):
    """A counter that gains 1 mJ every read (thread-safe enough: reads
    come from one sampling thread)."""

    def __init__(self):
        super().__init__()
        self.value = 0

    def nvmlDeviceGetTotalEnergyConsumption(self, handle, out):
        self.calls += 1
        self.value += 1
        out._obj.value = self.value
        return 0


def test_nvml_sampling_thread_reads_off_the_callers_path():
    """With poll_s, start/stop take the sampling thread's latest counter
    (no NVML call of their own), the counter moves between windows, and
    close() ends the thread; later reads call NVML again."""
    import threading
    import time

    lib = TickingNvml()
    b = port_power.NvmlBackend(lib=lib, poll_s=0.001)
    assert lib.calls == 0                     # nothing before start
    token = b.start()
    poller = b._poller
    assert poller is not None and poller.daemon and poller.is_alive()
    deadline = time.monotonic() + 5.0
    while lib.calls < 20 and time.monotonic() < deadline:
        time.sleep(0.001)
    b.close()
    assert not poller.is_alive()
    after = lib.calls
    assert after >= 20
    assert b.start() and lib.calls == after + 1   # direct read after close
    assert "nvml-energy-poll" not in {t.name for t in threading.enumerate()}
    # a window over the sampled counter is its latest reading's delta
    lib2 = TickingNvml()
    b2 = port_power.NvmlBackend(lib=lib2, poll_s=60.0)
    t0 = b2.start()                           # one sample, then the thread
    calls = lib2.calls
    assert t0 == [(1, None)]
    assert b2.stop(t0, 1.0) == {"gpu0": 0.0} and lib2.calls == calls
    b2._sampled = [1001]                      # the thread's next reading
    assert b2.stop(t0, 1.0) == {"gpu0": pytest.approx(1.0)}
    b2.close()
    with pytest.raises(ValueError):
        port_power.NvmlBackend(lib=FakeNvml(), poll_s=0.0)


def test_nvml_sampling_thread_ends_with_its_backend():
    import gc
    import time

    b = port_power.NvmlBackend(lib=TickingNvml(), poll_s=0.001)
    b.start()
    poller = b._poller
    del b
    gc.collect()
    poller.join(timeout=5.0)
    assert not poller.is_alive()


def test_detect_backend_builds_a_sampling_nvml(monkeypatch):
    monkeypatch.setattr(port_power.backends, "NvmlBackend",
                        lambda **kw: ("nvml", kw))
    got = port_power.detect_backend("nvml", rapl_root="/nonexistent")
    assert got == ("nvml", {"poll_s": port_power.NVML_POLL_S})


@pytest.mark.parametrize("lib", [None, FakeNvml(devices=0),
                                 FakeNvml(fail_init=True)])
def test_nvml_missing_library_or_device_raises(monkeypatch, lib):
    """The constructor raises where the library, its initialisation or a
    device is missing (no degrading inside it); available() says False
    and auto-detection moves on."""
    if lib is None:
        monkeypatch.setattr(port_power.backends, "NVML_LIBRARY",
                            "libnvidia-ml-absent.so.1")
        with pytest.raises(OSError):
            port_power.NvmlBackend()
        assert not port_power.NvmlBackend.available()
        assert port_power.detect_backend("nvml", rapl_root="/nonexistent"
                                         ).name == "model"
    else:
        with pytest.raises(RuntimeError):
            port_power.NvmlBackend(lib=lib)


def test_nvml_binds_ctypes_signatures():
    """Every entry point the backend calls has its argtypes and restype
    declared for the real library."""
    sig = port_power.backends._NVML_SIGNATURES
    assert set(sig) == {n for n in dir(FakeNvml) if n.startswith("nvml")}
    for args, res in sig.values():
        assert res is ctypes.c_int and isinstance(args, list)


# ------------------------------------------------------------------- meter
def test_meter_nesting_and_decorator_equal_reference():
    def run(pkg):
        b = pkg.ModelBackend()
        rep = pkg.EnergyReport()
        with pkg.EnergyMeter("outer", backend=b, reporter=rep) as outer:
            with pkg.EnergyMeter("inner-1", backend=b):
                pass
            with pkg.EnergyMeter("inner-2", backend=b) as i2, \
                    pkg.EnergyMeter("leaf", backend=b):
                pass
        m = pkg.EnergyMeter("fn", backend=b)
        work = m(lambda: 7)
        assert work() == 7 and work() == 7
        return ([c.label for c in outer.reading.children],
                [c.label for c in i2.reading.children],
                [x.label for x in rep.readings], len(m.readings),
                m.reading is m.readings[-1])

    assert run(port_power) == run(ref_power) == (
        ["inner-1", "inner-2"], ["leaf"], ["outer"], 2, True)


class _DeadOnStart:
    name = "dead"
    primary_domains = ("x",)

    def start(self):
        raise OSError("counter gone")

    def stop(self, token, elapsed_s, hints=None):  # pragma: no cover
        raise AssertionError("stop after a failed start")


def test_start_failed_sentinel_reads_zero_and_counts_a_fault():
    faults = default_registry().counter("power.faults")
    before = faults.value
    rep = port_power.EnergyReport()
    with port_power.EnergyMeter("s", backend=_DeadOnStart(),
                                reporter=rep) as em:
        pass
    assert em.reading.joules == 0.0 and em.reading.domains == {}
    assert em.reading.seconds >= 0.0
    assert faults.value == before + 1
    assert [r.label for r in rep.readings] == ["s"]


# ---------------------------------------------------------- model + report
@pytest.mark.parametrize("hints", [None, dict(flops=3e12, hbm_bytes=4e9,
                                              ici_bytes=1e8, f_scale=0.75)])
def test_model_backend_equals_reference(hints):
    mine = port_power.ModelBackend(hw=REF_HW).stop(
        None, 0.25, port_power.WorkloadHints(**hints) if hints else None)
    ref = ref_power.ModelBackend(hw=ref_energy.TPU_V5E).stop(
        None, 0.25, ref_power.WorkloadHints(**hints) if hints else None)
    assert mine.keys() == ref.keys()
    for k in mine:
        assert mine[k] == pytest.approx(ref[k], rel=1e-12, abs=0.0)
    assert port_power.ModelBackend().hw.name == "h100-sxm5-80gb"


def test_report_validates_under_both_packages(tmp_path):
    rep = port_power.EnergyReport(meta={"run": "test"})
    b = port_power.NvmlBackend(lib=FakeNvml(energy_mj=(0, 1500, 1500, 4000)))
    with port_power.EnergyMeter("a", backend=b, reporter=rep, flops=1e6):
        with port_power.EnergyMeter("a.1", backend=port_power.ModelBackend()):
            pass
    with port_power.EnergyMeter("b", backend=b, reporter=rep):
        pass
    d = json.loads(json.dumps(rep.to_dict()))
    assert port_power.validate_report(d) == [] == ref_power.validate_report(d)
    assert d["backend"] == "nvml"
    assert d["totals"]["joules"] == pytest.approx(4.0)
    path = str(tmp_path / "r.json")
    rep.write(path)
    assert port_power.report.main([path]) == 0
    bad = dict(d, schema_version=99)
    assert port_power.validate_report(bad) == ref_power.validate_report(bad)
    payload = {"schema_version": 2, "git_sha": "x", "backend": "cuda",
               "power_backend": "nvml", "results": {}, "energy": d}
    assert port_power.validate_bench_payload(payload) == [] == \
        ref_power.validate_bench_payload(payload)
