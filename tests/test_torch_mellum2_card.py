"""mellum2-12b's kernels on the card: B5 (``sfc_matmul_grouped``) at the
cell's decode and chunk shapes, and B2 with and without a window at its
attention shapes, each against its plain version on the same card, and
the routed moe layer at full width.

Marked ``card``: every test skips without a CUDA card, decided when it
runs.  On the card: ``python3 -m pytest -q tests/test_torch_mellum2_card.py``.
The file imports no JAX.

Bounds: bf16 outputs within atol = rtol = 2e-2 (one bf16 rounding of
values up to ~4, both sides summing the same bf16 products in f32 in
another order); B5's f32 outputs within 1e-3 (f32 order over K <= 2304
terms); B2 as ``tests/test_torch_paged_attention.py`` bounds it.  Two
launches give the same bits."""
import math

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.kernels import ref as kref  # noqa: E402
from repro_torch.kernels import sfc_matmul_grouped as b5  # noqa: E402

pytestmark = pytest.mark.card

BF16 = dict(rtol=2e-2, atol=2e-2)
D, F, E, K_TOP = 2304, 896, 64, 8


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card; run on the card with python3 -m "
                    "pytest tests/test_torch_mellum2_card.py")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _routed(dev, tokens, seed, skew=False):
    """Rows of ``tokens`` tokens' top-8 sorted by expert, their offsets,
    and the experts' weights (bf16 on ``dev``)."""
    g = torch.Generator().manual_seed(seed)
    logits = torch.randn(tokens, E, generator=g)
    if skew:
        logits[:, 3] += 10.0      # every token picks expert 3
    idx = logits.topk(K_TOP, dim=-1).indices.reshape(-1)
    order = torch.argsort(idx, stable=True)
    counts = torch.bincount(idx, minlength=E)
    off = torch.zeros(E + 1, dtype=torch.int32)
    off[1:] = torch.cumsum(counts, 0)
    x = torch.randn(tokens, D, generator=g)[order // K_TOP]
    w1 = torch.randn(E, D, F, generator=g) / math.sqrt(D)
    w3 = torch.randn(E, D, F, generator=g) / math.sqrt(D)
    w2 = torch.randn(E, F, D, generator=g) / math.sqrt(F)
    bf = torch.bfloat16
    return (x.to(dev, bf), off.to(dev), w1.to(dev, bf), w3.to(dev, bf),
            w2.to(dev, bf))


@pytest.mark.parametrize("tokens,skew", [(1, False), (7, False), (8, True),
                                         (256, False), (256, True)])
def test_b5_matches_its_plain_version(dev, tokens, skew):
    x, off, w1, w3, w2 = _routed(dev, tokens, tokens + skew, skew)
    n0 = b5.grouped_launches
    h = b5.sfc_matmul_grouped(x, w1, off, w3=w3, seg_max=tokens,
                              schedule="hilbert")
    y = b5.sfc_matmul_grouped(h, w2, off, seg_max=tokens,
                              out_dtype=torch.float32)
    torch.cuda.synchronize()
    assert b5.grouped_launches == n0 + 2
    hp = b5.sfc_matmul_grouped_plain(x, w1, off, w3=w3)
    torch.testing.assert_close(h.float(), hp.float(), **BF16)
    yp = b5.sfc_matmul_grouped_plain(h, w2, off, out_dtype=torch.float32)
    torch.testing.assert_close(y, yp, rtol=1e-3, atol=1e-3)
    # the same bits again, and under another curve
    h2 = b5.sfc_matmul_grouped(x, w1, off, w3=w3, seg_max=tokens,
                               schedule="hilbert")
    y2 = b5.sfc_matmul_grouped(h2, w2, off, seg_max=tokens,
                               out_dtype=torch.float32)
    assert torch.equal(h, h2) and torch.equal(y, y2)
    h3 = b5.sfc_matmul_grouped(x, w1, off, w3=w3, seg_max=tokens,
                               schedule="rowmajor")
    assert torch.equal(h, h3)


def test_routed_moe_layer_at_full_width(dev):
    from repro_torch.configs import get_config
    from repro_torch.models import DotEngine
    from repro_torch.models.moe import moe_routed

    cfg = get_config("mellum2_12b_a2_5b")
    g = torch.Generator().manual_seed(11)
    p = {"router": (torch.randn(D, E, generator=g) / math.sqrt(D)).to(dev),
         "w1": (torch.randn(E, D, F, generator=g) / math.sqrt(D)).to(
             dev, torch.bfloat16),
         "w3": (torch.randn(E, D, F, generator=g) / math.sqrt(D)).to(
             dev, torch.bfloat16),
         "w2": (torch.randn(E, F, D, generator=g) / math.sqrt(F)).to(
             dev, torch.bfloat16)}
    for t in (7, 256):
        x = torch.randn(t, D, generator=g).to(dev, torch.bfloat16)
        y = moe_routed(x, p, cfg, DotEngine())
        assert torch.equal(y, moe_routed(x, p, cfg, DotEngine()))
        probs = torch.softmax(x.float() @ p["router"], -1)
        w, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
        w, idx = w[:, :8] / w[:, :8].sum(-1, keepdim=True), idx[:, :8]
        want = torch.zeros(t, D, device=dev)
        for e in range(E):
            tok, slot = (idx == e).nonzero(as_tuple=True)
            if not len(tok):
                continue
            xe = x[tok].float()
            u = (torch.nn.functional.silu(xe @ p["w1"][e].float())
                 * (xe @ p["w3"][e].float())).bfloat16().float()
            want[tok] += (u @ p["w2"][e].float()) * w[tok, slot][:, None]
        torch.testing.assert_close(y, want, rtol=2e-2, atol=2e-2)


@pytest.mark.parametrize("window", [None, 1024])
def test_b2_with_and_without_a_window(dev, window):
    g = torch.Generator().manual_seed(5)
    b, h, hkv, dh, ps, max_pages = 8, 32, 4, 128, 16, 521
    rows = b * max_pages + 1
    kp = (torch.randn(rows, ps, hkv, dh, generator=g) * 0.5).to(
        dev, torch.bfloat16)
    vp = torch.randn(rows, ps, hkv, dh, generator=g).to(dev, torch.bfloat16)
    kp[-1] = 0
    vp[-1] = 0
    tables = torch.randperm(rows - 1, generator=g)[:b * max_pages]
    tables = tables.reshape(b, max_pages).to(dev, torch.int32)
    q = torch.randn(b, h, dh, generator=g).to(dev, torch.bfloat16)
    pos = torch.tensor([0, 17, 1023, 1024, 2232, 4099, 7511, 8319],
                       device=dev)
    n0, w0 = pa_mod.launches, pa_mod.window_launches
    out = pa_mod.paged_decode_attention_cuda(q, kp, vp, tables, pos,
                                             window=window)
    again = pa_mod.paged_decode_attention_cuda(q, kp, vp, tables, pos,
                                               window=window)
    torch.cuda.synchronize()
    assert torch.equal(out, again)
    assert pa_mod.launches == n0 + 2
    assert pa_mod.window_launches == w0 + (2 if window else 0)
    want = kref.paged_decode_attention_ref(q, kp, vp, tables, pos, window)
    torch.testing.assert_close(out.float(), want.float(), rtol=2e-2,
                               atol=2e-2)
    for split in (1, 2, 4, 8):
        o = pa_mod.paged_decode_attention_cuda(q, kp, vp, tables, pos,
                                               window=window, split=split)
        torch.testing.assert_close(o.float(), want.float(), rtol=2e-2,
                                   atol=2e-2)
    if window:
        full = kref.paged_decode_attention_ref(q, kp, vp, tables, pos)
        # rows past the window differ from full attention; the others not
        far = (pos >= window).cpu().numpy()
        diff = (want.float() - full.float()).abs().amax((1, 2)).cpu().numpy()
        assert (diff[~far] < 1e-6).all() and (diff[far] > 1e-3).all()
    assert np.isfinite(out.float().cpu().numpy()).all()


@pytest.mark.parametrize("pos_", [1024, 1039, 2232, 4099])
def test_b2_window_edge_is_exact(dev, pos_):
    """The key just below the window, made to dominate any softmax that
    reads it, changes nothing; the one at the window's first position,
    made the same way, takes all the weight."""
    g = torch.Generator().manual_seed(pos_)
    b, h, hkv, dh, ps, max_pages, window = 1, 32, 4, 128, 16, 521, 1024
    rows = max_pages + 1
    kp = (torch.randn(rows, ps, hkv, dh, generator=g) * 0.1).to(dev)
    vp = torch.randn(rows, ps, hkv, dh, generator=g).to(dev)
    kp[-1] = 0
    vp[-1] = 0
    tables = torch.arange(max_pages, dtype=torch.int32,
                          device=dev).reshape(1, -1)
    q = torch.randn(b, h, dh, generator=g).to(dev)
    qk = q[0].reshape(hkv, h // hkv, dh).sum(1)          # (hkv, dh)
    out_pos = pos_ - window                              # just outside
    kp[out_pos // ps, out_pos % ps] = 50 * qk
    vp[out_pos // ps, out_pos % ps] = 1000.0
    pos = torch.tensor([pos_], device=dev)
    for dt in (torch.float32, torch.bfloat16):
        args = (q.to(dt), kp.to(dt), vp.to(dt), tables, pos)
        o = pa_mod.paged_decode_attention_cuda(*args, window=window)
        assert o.float().abs().max() < 50, (dt, o.float().abs().max())
        torch.testing.assert_close(
            o.float(), kref.paged_decode_attention_ref(
                *args, window).float(), rtol=2e-2, atol=2e-2)
    first = out_pos + 1                                  # just inside
    kp[first // ps, first % ps] = 50 * qk
    vp[first // ps, first % ps] = 1000.0
    o = pa_mod.paged_decode_attention_cuda(q, kp, vp, tables, pos,
                                           window=window)
    assert o.float().min() > 900
