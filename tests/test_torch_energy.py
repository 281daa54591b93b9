"""Port parity for the energy model: ``repro_torch.core.energy``'s
``roofline_terms``, ``energy_joules`` and ``clamp_f_scale`` equal
``repro.core.energy``'s on a grid of FLOPs, bytes, chips and f_scale
under the reference's own constants (``TPU_V5E``, read from ``repro``
here and nowhere in the port), within 1e-12 relative: the same float
arithmetic.  The port's one preset, ``H100``, carries the data sheet's
rates."""
import dataclasses
import itertools

import pytest
torch = pytest.importorskip("torch")

import repro.core.energy as ref
import repro_torch.core.energy as port

REF_HW = port.HW(**dataclasses.asdict(ref.TPU_V5E))
GRID = list(itertools.product(
    (0.0, 1e9, 3.7e14),          # flops
    (0.0, 2.5e8, 8.1e11),        # hbm bytes
    (0.0, 4e7),                  # ici bytes
    (1, 4, 256),                 # chips
    (0.3, 0.5, 0.8, 1.0, 1.25, 2.0),   # f_scale (clamped at both ends)
))


def _rel(a, b):
    return abs(a - b) <= 1e-12 * max(abs(a), abs(b))


@pytest.mark.parametrize("f_scale", [0.0, 0.3, 0.5, 0.77, 1.0, 1.25, 3.0])
def test_clamp_f_scale_equal(f_scale):
    assert port.clamp_f_scale(REF_HW, f_scale) == \
        ref.clamp_f_scale(ref.TPU_V5E, f_scale)
    assert port.F_SCALE_MAX == ref.F_SCALE_MAX


@pytest.mark.parametrize("dcn", [0.0, 3e9])
def test_roofline_terms_equal(dcn):
    for flops, hbm, ici, chips, f in GRID:
        a = port.roofline_terms(flops, hbm, ici, chips, REF_HW, f_scale=f,
                                dcn_bytes=dcn)
        b = ref.roofline_terms(flops, hbm, ici, chips, ref.TPU_V5E,
                               f_scale=f, dcn_bytes=dcn)
        for name in ("t_compute", "t_hbm", "t_ici", "t_dcn", "t_overlap",
                     "t_serial"):
            assert _rel(getattr(a, name), getattr(b, name)), name
        assert a.bottleneck == b.bottleneck
        assert _rel(a.fraction_of_roofline(flops, chips, REF_HW),
                    b.fraction_of_roofline(flops, chips, ref.TPU_V5E))


@pytest.mark.parametrize("overlap,wall", [(True, None), (False, None),
                                          (True, 0.0123)])
def test_energy_joules_equal(overlap, wall):
    for flops, hbm, ici, chips, f in GRID:
        a = port.energy_joules(flops, hbm, ici, chips, REF_HW, f_scale=f,
                               dcn_bytes=1e6, overlap=overlap,
                               wall_time=wall)
        b = ref.energy_joules(flops, hbm, ici, chips, ref.TPU_V5E,
                              f_scale=f, dcn_bytes=1e6, overlap=overlap,
                              wall_time=wall)
        for name in ("time", "core", "hbm", "ici", "dcn", "static", "total",
                     "f_scale"):
            assert _rel(a[name], b[name]), name


def test_h100_preset_is_the_default_and_the_data_sheet():
    """The preset's rates and sizes: NVIDIA H100 SXM5 80 GB data sheet
    (dense bf16 989 TFLOP/s, HBM3 3.35 TB/s, NVLink 900 GB/s over 18
    links, 80 GB), 227 KB of shared memory a block as the on-chip
    budget; the field names are the reference's."""
    h = port.H100
    assert port.HW() == h
    assert (h.peak_flops, h.hbm_bw, h.ici_bw * h.ici_links,
            h.hbm_per_chip, h.vmem_per_chip) == \
        (989e12, 3.35e12, 900e9, 80e9, 227 * 1024)
    assert [f.name for f in dataclasses.fields(port.HW)] == \
        [f.name for f in dataclasses.fields(ref.HW)]
    e = port.energy_joules(989e12, 0.0, 0.0, 1)
    assert e["time"] == pytest.approx(1.0)
    assert e["total"] == pytest.approx(700.0)   # the power limit at peak
