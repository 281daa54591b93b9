"""The card's energy counter, read through NVML with ``ctypes``.

``nvmlDeviceGetTotalEnergyConsumption`` gives the millijoules the card
has used since its NVIDIA driver loaded; the counter moves every ~100 ms,
so a window of tens of seconds reads it to a few tenths of a percent.
The benchmark keeps this reader of its own, so that no change to the
program can move how its joules are read.
"""
from __future__ import annotations

import ctypes
import os

__all__ = ["EnergyCounter"]

_LIB = "libnvidia-ml.so.1"


class EnergyCounter:
    """Joules of the NVML device that is CUDA device ``index`` (matched
    by UUID, so ``CUDA_VISIBLE_DEVICES`` cannot point it at another
    card).  Raises where NVML, the device or its counter is missing."""

    def __init__(self, index: int = 0):
        import torch

        lib = ctypes.CDLL(_LIB)
        lib.nvmlInit_v2.restype = ctypes.c_int
        lib.nvmlDeviceGetCount_v2.argtypes = [ctypes.POINTER(ctypes.c_uint)]
        lib.nvmlDeviceGetHandleByIndex_v2.argtypes = [
            ctypes.c_uint, ctypes.POINTER(ctypes.c_void_p)]
        lib.nvmlDeviceGetUUID.argtypes = [ctypes.c_void_p, ctypes.c_char_p,
                                          ctypes.c_uint]
        lib.nvmlDeviceGetTotalEnergyConsumption.argtypes = [
            ctypes.c_void_p, ctypes.POINTER(ctypes.c_ulonglong)]
        self._check(lib.nvmlInit_v2(), "nvmlInit_v2")
        self._lib = lib
        count = ctypes.c_uint(0)
        self._check(lib.nvmlDeviceGetCount_v2(ctypes.byref(count)),
                    "nvmlDeviceGetCount_v2")
        want = str(getattr(torch.cuda.get_device_properties(index), "uuid",
                           "")).lower().removeprefix("gpu-")
        handles = []
        for i in range(count.value):
            h = ctypes.c_void_p()
            self._check(lib.nvmlDeviceGetHandleByIndex_v2(i, ctypes.byref(h)),
                        "nvmlDeviceGetHandleByIndex_v2")
            buf = ctypes.create_string_buffer(96)
            uuid = ""
            if lib.nvmlDeviceGetUUID(h, buf, 96) == 0:
                uuid = buf.value.decode().lower().removeprefix("gpu-")
            handles.append((uuid, h))
        match = [h for uuid, h in handles if want and uuid == want]
        if match:
            self._handle = match[0]
        elif len(handles) == 1 or (
                index < len(handles)
                and not os.environ.get("CUDA_VISIBLE_DEVICES")):
            # UUIDs hidden: NVML's order is the CUDA order here
            self._handle = handles[min(index, len(handles) - 1)][1]
        else:
            raise RuntimeError(f"no NVML device has the UUID {want!r} of "
                               f"CUDA device {index}")
        self.joules()   # the counter must answer now, not mid-window

    @staticmethod
    def _check(ret: int, what: str) -> None:
        if ret != 0:
            raise RuntimeError(f"{what} failed: nvmlReturn_t {ret}")

    def joules(self) -> float:
        e = ctypes.c_ulonglong(0)
        self._check(self._lib.nvmlDeviceGetTotalEnergyConsumption(
            self._handle, ctypes.byref(e)),
            "nvmlDeviceGetTotalEnergyConsumption")
        return e.value / 1e3
