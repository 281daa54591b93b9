"""The reduction of a device trace, on events made up here, and the
kernel names the card's profiler gives."""
from __future__ import annotations

from perfbench.harness.kernels import is_b1, is_b2, is_b3
from perfbench.harness.profile import DeviceTrace, Spans, short_name

B1 = ("void (anonymous namespace)::sfc_matmul_tile<__nv_bfloat16, true, "
      "false>(__nv_bfloat16 const*, __nv_bfloat16 const*, int const*, int)")
B1_ROWS = ("void (anonymous namespace)::sfc_matmul_rows_bf16<false>("
           "__nv_bfloat16 const*, int)")
B3 = "void (anonymous namespace)::sfc_matmul_tile<float, true, true>(float)"
B2 = ("void (anonymous namespace)::paged_attn_kernel<__nv_bfloat16, 4, 8, "
      "true>(__nv_bfloat16 const*, CUtensorMap_st)")


def test_kernel_names():
    assert is_b1(B1) and is_b1(B1_ROWS) and not is_b1(B3)
    assert is_b3(B3) and not is_b3(B1)
    assert is_b2(B2) and not is_b2(B1)
    for other in ("Memcpy DtoD (Device -> Device)",
                  "void sfc_matmul_cached_kernel<float>(float const*)",
                  "void at::native::vectorized_elementwise_kernel<4>(int)"):
        assert not (is_b1(other) or is_b2(other) or is_b3(other))
    assert short_name(B3) == "sfc_matmul_tile<float, true, true>"


def test_busy_union_clipping_and_gaps():
    ms = 1_000_000
    ev = [("k1", -5 * ms, 10 * ms),      # clipped at the window's start
          ("k2", 5 * ms, 20 * ms),       # overlaps k1
          ("k1", 30 * ms, 40 * ms),
          ("k3", 95 * ms, 200 * ms)]     # clipped at its end
    tr = DeviceTrace(ev, 0, 100 * ms)
    assert tr.window_s == 0.1
    assert abs(tr.busy_s - 0.035) < 1e-12
    assert tr.gaps() == [(20 * ms, 30 * ms), (40 * ms, 95 * ms)]
    assert abs(tr.seconds(lambda n: n == "k1") - 0.020) < 1e-12
    top = dict(tr.top_ops())
    assert abs(top["k2"] - 0.015) < 1e-12

    spans = Spans()
    spans.items += [("outer", 0, 100 * ms), ("serve.decode", 22 * ms,
                                             29 * ms),
                    ("bench.clients", 41 * ms, 90 * ms)]
    idle = dict(tr.idle_by_host(spans))
    assert abs(idle["serve.decode"] - 0.010) < 1e-12
    assert abs(idle["bench.clients"] - 0.055) < 1e-12


def test_program_spans_move_onto_the_wall_clock():
    spans = Spans()
    spans.add_program_events(
        [{"ph": "X", "name": "serve.decode", "ts": 10.0, "dur": 5.0},
         {"ph": "i", "name": "serve.faults.nan", "ts": 11.0},
         {"ph": "X", "name": "serve.other", "ts": 12.0, "dur": 1.0}],
        mono_to_wall_ns=1_000, names={"serve.decode"})
    assert spans.items == [("serve.decode", 11_000, 16_000)]


def test_disabled_spans_record_nothing():
    spans = Spans(enabled=False)
    with spans.span("x"):
        pass
    assert spans.items == []
