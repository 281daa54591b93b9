"""Pluggable energy telemetry backends (port of ``repro.power.backends``).

Three backends behind one protocol, in the reference's order:

* :class:`RaplBackend`  -- Linux powercap (``/sys/class/powercap``),
  per-domain package/dram counters with wraparound handling: the CPU
  package's joules, not the card's.
* :class:`NvmlBackend`  -- the card's joules: NVML's cumulative
  energy counter, bound with ``ctypes`` from ``libnvidia-ml.so.1``,
  otherwise integration of the instantaneous power draw.
* :class:`ModelBackend` -- the analytic model
  (:mod:`repro_torch.core.energy`, :data:`~repro_torch.core.energy.H100`
  by default) fed by workload hints and the measured wall time.

:func:`detect_backend` auto-selects (rapl > nvml > model) with graceful
fallback; ``REPRO_POWER_BACKEND`` pins a choice.  Where the powercap
tree is readable, auto-selection returns RAPL, so a reading of the card
names ``"nvml"``.
"""
from __future__ import annotations

import ctypes
import os
import threading
import weakref
from dataclasses import dataclass
from typing import Any, Protocol, runtime_checkable

from repro_torch.core.energy import H100, HW, energy_joules

__all__ = ["WorkloadHints", "PowerBackend", "RaplBackend", "NvmlBackend",
           "ModelBackend", "detect_backend", "RAPL_SYSFS_ROOT",
           "NVML_LIBRARY", "NVML_POLL_S"]

# period of the sampling thread of the NvmlBackend that detect_backend
# builds: the H100's counter moves every 100 ms
NVML_POLL_S = 0.02

RAPL_SYSFS_ROOT = "/sys/class/powercap"
_ENV_BACKEND = "REPRO_POWER_BACKEND"


@dataclass(frozen=True)
class WorkloadHints:
    """What ran inside a metered region, for model-based accounting.

    Counter backends ignore hints (the hardware saw the work); the
    :class:`ModelBackend` combines them with the measured wall time.
    ``flops`` also feeds the derived J/FLOP on every backend's readings.
    ``hw=None`` (the default) defers to the backend's configured HW, so
    a calibrated ``ModelBackend(hw=...)`` is not silently overridden.
    """

    flops: float = 0.0
    hbm_bytes: float = 0.0
    ici_bytes: float = 0.0
    dcn_bytes: float = 0.0
    chips: int = 1
    f_scale: float = 1.0
    hw: HW | None = None
    # optional breakdown of hbm_bytes for telemetry (DESIGN.md §10): the
    # serve loop reports attention-cache traffic (paged gather vs
    # contiguous strips) next to the GEMM weight/activation traffic, so
    # a J/step reading can be attributed to the cache layout.  Purely
    # informational -- the energy model consumes hbm_bytes.
    attn_bytes: float = 0.0
    gemm_bytes: float = 0.0


@runtime_checkable
class PowerBackend(Protocol):
    """One energy-measurement instrument.

    ``start()`` returns an opaque token (typically a counter snapshot);
    ``stop(token, elapsed_s, hints)`` returns joules by domain for the
    interval.  Domain names are backend-specific ("package-0"/"dram" for
    RAPL, "gpu0" for NVML, "core"/"hbm"/"static"/... for the model);
    ``primary_domains`` lists the non-overlapping domains whose sum is
    the total (RAPL subzones are *contained in* their package zone and
    must not be double-counted).
    """

    name: str
    primary_domains: tuple[str, ...]

    def start(self) -> Any: ...

    def stop(self, token: Any, elapsed_s: float,
             hints: WorkloadHints | None = None) -> dict[str, float]: ...


# --------------------------------------------------------------------- RAPL
class RaplBackend:
    """Linux powercap RAPL counters.

    Walks ``<root>/intel-rapl:*`` zones (and one level of ``:N:M``
    subzones), reading ``energy_uj`` (cumulative microjoules) and
    ``max_energy_range_uj`` (the wraparound modulus).  Counter deltas
    are taken modulo the range, so a single wrap during a metered region
    is handled exactly; totals sum only top-level zones (subzone energy
    is already contained in its package).
    """

    name = "rapl"

    def __init__(self, root: str | None = None):
        self.root = root or RAPL_SYSFS_ROOT
        # label -> (energy_uj path, max_range_uj); insertion order = walk order
        self._domains: dict[str, tuple[str, int]] = {}
        self.primary_domains: tuple[str, ...] = ()
        self._discover()
        if not self._domains:
            raise RuntimeError(f"no readable RAPL zones under {self.root}")

    @classmethod
    def available(cls, root: str | None = None) -> bool:
        try:
            return bool(cls(root)._domains)
        except (OSError, RuntimeError):
            return False

    def _zone_label(self, zdir: str, taken) -> str | None:
        try:
            with open(os.path.join(zdir, "name")) as f:
                label = f.read().strip()
            # probe readability now: perms differ per distro
            self._read_uj(os.path.join(zdir, "energy_uj"))
        except (OSError, ValueError):
            return None
        base, i = label, 1
        while label in taken:
            i += 1
            label = f"{base}:{i}"
        return label

    def _discover(self) -> None:
        try:
            zones = sorted(e for e in os.listdir(self.root)
                           if e.startswith("intel-rapl:"))
        except OSError:
            return
        primaries = []
        for z in zones:
            zdir = os.path.join(self.root, z)
            if not os.path.isdir(zdir):
                continue
            label = self._zone_label(zdir, self._domains)
            if label is None:
                continue
            self._domains[label] = (
                os.path.join(zdir, "energy_uj"),
                self._max_range(zdir))
            # top-level zones are "intel-rapl:N" (one ':'); subzones
            # "intel-rapl:N:M" nest inside them
            if z.count(":") == 1:
                primaries.append(label)
        self.primary_domains = tuple(primaries)

    @staticmethod
    def _max_range(zdir: str) -> int:
        try:
            with open(os.path.join(zdir, "max_energy_range_uj")) as f:
                return max(int(f.read().strip()), 1)
        except (OSError, ValueError):
            return 2 ** 32  # common hardware default; only wrap handling cares

    @staticmethod
    def _read_uj(path: str) -> int:
        with open(path) as f:
            return int(f.read().strip())

    def start(self) -> dict[str, int]:
        return {label: self._read_uj(path)
                for label, (path, _) in self._domains.items()}

    def stop(self, token: dict[str, int], elapsed_s: float,
             hints: WorkloadHints | None = None) -> dict[str, float]:
        out = {}
        for label, (path, max_range) in self._domains.items():
            if label not in token:
                continue
            delta = self._read_uj(path) - token[label]
            if delta < 0:  # counter wrapped (at most once per sane interval)
                delta += max_range
            out[label] = delta * 1e-6
        return out


# --------------------------------------------------------------------- NVML
# the NVML entry points the backend binds: name -> (argtypes, restype);
# nvmlDevice_t is an opaque pointer, return codes are nvmlReturn_t
# (0 = NVML_SUCCESS)
_NVML_SIGNATURES = {
    "nvmlInit_v2": ([], ctypes.c_int),
    "nvmlDeviceGetCount_v2": ([ctypes.POINTER(ctypes.c_uint)], ctypes.c_int),
    "nvmlDeviceGetHandleByIndex_v2": (
        [ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)], ctypes.c_int),
    "nvmlDeviceGetTotalEnergyConsumption": (
        [ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)], ctypes.c_int),
    "nvmlDeviceGetPowerUsage": (
        [ctypes.c_void_p, ctypes.POINTER(ctypes.c_uint)], ctypes.c_int),
}
NVML_LIBRARY = "libnvidia-ml.so.1"


class NvmlBackend:
    """GPU energy through NVML, bound with ``ctypes`` from
    ``libnvidia-ml.so.1`` (present wherever ``nvidia-smi`` runs; no
    pynvml).

    Prefers the cumulative mJ counter
    (``nvmlDeviceGetTotalEnergyConsumption``, Volta and later); a device
    without it falls back to integrating instantaneous power
    (``nvmlDeviceGetPowerUsage``, mW) over the interval, the trapezoid of
    both ends, or the end's draw alone where the counter answered at
    the start and fails at the end.  Power is read only where the
    counter is missing.  The constructor raises when the library, its
    initialisation or a device handle is missing (:meth:`available`
    turns that into False); once built, an NVML call that fails degrades
    to a missing domain, never an exception on the hot path.  ``lib``
    replaces the loaded library (an object with the five entry points,
    for tests).

    Each NVML call costs milliseconds of host time on the H100's
    machine, and a metered serving step reads twice.  With ``poll_s``
    set, a daemon thread reads the counter every ``poll_s`` seconds
    (started by the first ``start``, stopped by :meth:`close` or when
    the backend is collected; ctypes releases the GIL for the call) and
    ``start``/``stop`` take its latest reading, at most ``poll_s`` older
    than a direct read; the counter itself only moves at its update
    interval.  Without ``poll_s`` every ``start``/``stop`` calls NVML.
    """

    name = "nvml"

    def __init__(self, lib=None, *, poll_s: float | None = None):
        if lib is None:
            lib = ctypes.CDLL(NVML_LIBRARY)  # OSError propagates
        if isinstance(lib, ctypes.CDLL):
            for fn, (args, res) in _NVML_SIGNATURES.items():
                getattr(lib, fn).argtypes = args
                getattr(lib, fn).restype = res
        self._lib = lib
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        count = ctypes.c_uint(0)
        self._check(lib.nvmlDeviceGetCount_v2(ctypes.byref(count)),
                    "nvmlDeviceGetCount_v2")
        self._handles = []
        for i in range(count.value):
            h = ctypes.c_void_p()
            self._check(lib.nvmlDeviceGetHandleByIndex_v2(
                i, ctypes.byref(h)), "nvmlDeviceGetHandleByIndex_v2")
            self._handles.append(h)
        if not self._handles:
            raise RuntimeError("NVML initialised but no devices")
        self.primary_domains = tuple(f"gpu{i}"
                                     for i in range(len(self._handles)))
        if poll_s is not None and poll_s <= 0:
            raise ValueError(f"poll_s must be positive, got {poll_s}")
        self.poll_s = poll_s
        self._sampled: list[int | None] | None = None
        self._halt = threading.Event()
        self._poller: threading.Thread | None = None

    def _sample(self) -> list[int | None]:
        return [self._energy_mj(h) for h in self._handles]

    @staticmethod
    def _poll(ref, halt: threading.Event, period: float) -> None:
        # holds the backend only while it reads, so an unused backend is
        # collected and its thread ends
        while not halt.wait(period):
            backend = ref()
            if backend is None:
                return
            backend._sampled = backend._sample()
            del backend

    def _ensure_poller(self) -> None:
        if self.poll_s is None or self._poller is not None:
            return
        self._sampled = self._sample()
        self._poller = threading.Thread(
            target=self._poll, name="nvml-energy-poll", daemon=True,
            args=(weakref.ref(self), self._halt, self.poll_s))
        self._poller.start()

    def close(self) -> None:
        """Stop the sampling thread (if any); later reads call NVML."""
        self._halt.set()
        if self._poller is not None:
            self._poller.join()
        self._poller, self._sampled, self.poll_s = None, None, None

    def _counter_mj(self, i: int) -> int | None:
        sampled = self._sampled
        if sampled is not None and sampled[i] is not None:
            return sampled[i]
        return self._energy_mj(self._handles[i])

    @staticmethod
    def _check(ret: int, what: str) -> None:
        if ret != 0:
            raise RuntimeError(f"{what} failed: nvmlReturn_t {ret}")

    @classmethod
    def available(cls) -> bool:
        try:
            cls()
            return True
        except Exception:  # library missing, init failed, no device, ...
            return False

    def _energy_mj(self, handle) -> int | None:
        e = ctypes.c_ulonglong(0)
        try:
            ret = self._lib.nvmlDeviceGetTotalEnergyConsumption(
                handle, ctypes.byref(e))
        except Exception:
            return None
        return int(e.value) if ret == 0 else None

    def _power_w(self, handle) -> float | None:
        p = ctypes.c_uint(0)
        try:
            ret = self._lib.nvmlDeviceGetPowerUsage(handle, ctypes.byref(p))
        except Exception:
            return None
        return p.value * 1e-3 if ret == 0 else None

    def start(self) -> list[tuple[int | None, float | None]]:
        self._ensure_poller()
        out = []
        for i, h in enumerate(self._handles):
            e0 = self._counter_mj(i)
            out.append((e0, self._power_w(h) if e0 is None else None))
        return out

    def stop(self, token, elapsed_s: float,
             hints: WorkloadHints | None = None) -> dict[str, float]:
        out = {}
        for i, (h, (e0, p0)) in enumerate(zip(self._handles, token)):
            e1 = self._counter_mj(i)
            if e0 is not None and e1 is not None:
                out[f"gpu{i}"] = max(e1 - e0, 0) * 1e-3
                continue
            p1 = self._power_w(h)
            if p1 is not None:
                p0 = p1 if p0 is None else p0
                out[f"gpu{i}"] = 0.5 * (p0 + p1) * elapsed_s
        return out


# -------------------------------------------------------------------- model
class ModelBackend:
    """Analytic accounting when no counter exists (DESIGN.md §7).

    Energy is ``energy_joules(hints..., wall_time=elapsed)``: dynamic
    terms come from the workload hints (FLOPs / HBM / ICI / DCN bytes --
    typically produced by the LRU traffic simulator or the HLO cost
    analyzer), static power from the measured wall time.  With no hints
    at all the reading degrades to static power x time, which is still a
    non-degenerate, comparable number.
    """

    name = "model"
    primary_domains = ("core", "hbm", "ici", "dcn", "static")

    def __init__(self, hw: HW = H100,
                 default_hints: WorkloadHints | None = None):
        self.hw = hw
        self.default_hints = default_hints

    @classmethod
    def available(cls) -> bool:
        return True

    def start(self) -> None:
        return None

    def stop(self, token: None, elapsed_s: float,
             hints: WorkloadHints | None = None) -> dict[str, float]:
        h = hints or self.default_hints or WorkloadHints()
        e = energy_joules(h.flops, h.hbm_bytes, h.ici_bytes, h.chips,
                          hw=h.hw or self.hw, f_scale=h.f_scale,
                          dcn_bytes=h.dcn_bytes, wall_time=elapsed_s)
        return {d: float(e[d]) for d in self.primary_domains}


# ---------------------------------------------------------------- detection
def detect_backend(prefer: str | None = None, *,
                   rapl_root: str | None = None,
                   hw: HW = H100) -> PowerBackend:
    """Pick the best available backend.

    Order: explicit ``prefer`` (or ``$REPRO_POWER_BACKEND``), then RAPL,
    then NVML, then the analytic model.  An unavailable preference falls
    back down the same chain rather than raising: telemetry must never
    take down the workload it observes.  The NVML backend built here
    reads its counter on a sampling thread (``poll_s=NVML_POLL_S``), so
    metering a step costs the caller no NVML call.
    """
    prefer = prefer or os.environ.get(_ENV_BACKEND) or None
    order = ["rapl", "nvml", "model"]
    if prefer is not None:
        if prefer not in order:
            raise ValueError(
                f"unknown power backend {prefer!r}; choose from {order}")
        order = [prefer] + [b for b in order if b != prefer]
    for name in order:
        # construct once and keep the instance: probing availability via
        # a throwaway construction would double the sysfs walk (RAPL) or
        # leak a second NVML init on every detection
        try:
            if name == "rapl":
                return RaplBackend(rapl_root)
            if name == "nvml":
                return NvmlBackend(poll_s=NVML_POLL_S)
            return ModelBackend(hw=hw)  # name == "model": always available
        except Exception:
            continue
    return ModelBackend(hw=hw)  # every counter backend failed

