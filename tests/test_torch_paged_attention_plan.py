"""The paged attention kernel's split (``repro_torch.kernels.
paged_attention``): the cluster size the host plans, the page ranges
each rank takes on the device, the shared memory a block needs, and the
kernel's split-and-merge algorithm in plain PyTorch
(``paged_decode_attention_split_ref``) against ``repro``'s Pallas
kernel in interpret mode and its gather reference.  The kernel that
runs the plan is checked on the card by ``chip_smoke.py``.

Bounds: f32 agrees within atol = 2e-6, rtol = 0 (summation order and
the rank merge's rescaling versus one direct softmax; outputs are O(1)).
bf16 within atol = rtol = 1e-2: the mirror keeps scores and weights in
f32 as the Pallas kernel does (one bf16 rounding of the output apart
from it), while the gather reference rounds both to bf16."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.kernels.paged_attention import paged_decode_attention_pallas
from repro.kernels.ref import paged_decode_attention_ref as jax_ref
from repro_torch.kernels.paged_attention import attn_launch_plan, \
    attn_smem_bytes, attn_split_plan, attn_stage_pages, head_chunks, \
    paged_decode_attention_cuda
from repro_torch.kernels.ref import attn_live_pages, attn_page_ranges, \
    paged_decode_attention_split_ref
from repro_torch.models.convert import tensor_from_numpy

SMS = 132          # NVIDIA H100 SXM
SMEM = 232448      # bytes of shared memory one block may use
F32 = dict(rtol=0, atol=2e-6)
BF16 = dict(rtol=1e-2, atol=1e-2)

# (name, slots, kv-heads, max_pages, split): qwen3-1.7b (8 kv-heads) with
# 16-token pages: the serving path's 64-token cache (too few pages to
# split), then 512, 4096 and 32768 tokens of context
QWEN3_1_7B = [("serving", 4, 8, 4, 1), ("ctx512", 4, 8, 32, 4),
              ("ctx4096", 4, 8, 256, 8), ("ctx32768", 4, 8, 2048, 8),
              ("one-slot", 1, 8, 2048, 8), ("16-slots", 16, 8, 2048, 2),
              ("32-slots", 32, 8, 2048, 1)]


@pytest.mark.parametrize("name,b,hkv,maxp,split", QWEN3_1_7B,
                         ids=[c[0] for c in QWEN3_1_7B])
def test_qwen3_shapes_get_the_planned_split(name, b, hkv, maxp, split):
    assert attn_split_plan(b, hkv, maxp, SMS) == split


def test_split_leaves_each_rank_eight_pages_and_stops_at_eight():
    assert attn_split_plan(1, 1, 1, SMS) == 1
    assert attn_split_plan(1, 1, 15, SMS) == 1
    assert attn_split_plan(1, 1, 16, SMS) == 2
    assert attn_split_plan(1, 1, 63, SMS) == 4
    assert attn_split_plan(1, 1, 4096, SMS) == 8
    assert attn_split_plan(4, 8, 4096, 32) == 1      # fewer SMs, less split
    # a GQA group past four heads runs in chunks, which count as blocks
    assert head_chunks(2) == 1 and head_chunks(4) == 1
    assert head_chunks(7) == 2 and head_chunks(16) == 4
    assert attn_split_plan(4, 2, 2048, SMS, head_chunks(16)) == 8
    assert attn_split_plan(4, 8, 2048, SMS, head_chunks(7)) == 4


@pytest.mark.parametrize("split", range(1, 9))
def test_page_ranges_cover_live_pages_once_in_order(split):
    for live in range(0, 41):
        ranges = attn_page_ranges(live, split)
        assert len(ranges) == split
        assert ranges[0][0] == 0 and ranges[-1][1] == live
        sizes = []
        for (lo, hi), (nxt, _) in zip(ranges, ranges[1:] + [(live, live)]):
            assert lo <= hi == nxt
            sizes.append(hi - lo)
        assert max(sizes) - min(sizes) <= 1
        if split > live:     # every page on its own rank, the rest empty
            assert sorted(sizes) == [0] * (split - live) + [1] * live


@pytest.mark.parametrize("ps", [4, 8, 16])
def test_live_pages_clamp_past_the_table(ps):
    maxp = 6
    assert attn_live_pages(-1, ps, maxp) == 0
    assert attn_live_pages(0, ps, maxp) == 1
    assert attn_live_pages(ps - 1, ps, maxp) == 1
    assert attn_live_pages(ps, ps, maxp) == 2
    assert attn_live_pages(ps * maxp - 1, ps, maxp) == maxp
    assert attn_live_pages(ps * maxp + 100, ps, maxp) == maxp


@pytest.mark.parametrize("itemsize", [2, 4], ids=["bf16", "f32"])
@pytest.mark.parametrize("ps", [1, 4, 8, 16, 32, 64])
def test_stages_fill_32kb_and_fit_shared_memory(ps, itemsize):
    dh = 128
    p = attn_stage_pages(ps, dh, itemsize)
    page = 2 * ps * dh * itemsize
    assert p & (p - 1) == 0 and 1 <= p <= 64
    assert p * page <= 32768 or p == 1
    assert p == 64 or 2 * p * page > 32768
    assert attn_smem_bytes(ps, dh, itemsize, p, 2) <= SMEM


def test_serving_stage_and_shared_memory():
    # 16-token bf16 pages, d_head 128: four pages (32 KB) a stage, two
    # stages, the table and the stages' barriers: three blocks to an SM
    assert attn_stage_pages(16, 128, 2) == 4
    assert attn_smem_bytes(16, 128, 2, 4, 2) == 2 * 32768 + 4096 + 2 * 8
    assert 3 * attn_smem_bytes(16, 128, 2, 4, 2) <= 233472  # one SM's
    assert attn_stage_pages(16, 128, 4) == 2
    # a 256-token f32 page of d_head 256 does not fit the ring
    assert attn_smem_bytes(256, 256, 4, attn_stage_pages(256, 256, 4),
                           2) > SMEM


# (slots, q heads, kv-heads, d_head, page size, max_pages, itemsize): the
# serving shape and 32768 tokens in bf16, f32, a group of 7, d_head 100
LAUNCH_SHAPES = [(4, 16, 8, 128, 16, 4, 2), (4, 16, 8, 128, 16, 2048, 2),
                 (4, 16, 8, 128, 8, 4096, 4), (4, 14, 2, 128, 16, 6, 2),
                 (4, 16, 8, 100, 16, 6, 2), (4, 16, 8, 100, 16, 6, 4)]


@pytest.mark.parametrize("b,h,hkv,dh,ps,maxp,es", LAUNCH_SHAPES)
def test_launch_plan_is_the_plan_of_its_parts(b, h, hkv, dh, ps, maxp, es):
    """The per-shape plan the wrapper caches: stage pages, split and the
    TMA route (16-byte rows, 128-byte page slots) of its parts."""
    stage, split, vec = attn_launch_plan(b, h, hkv, dh, ps, maxp, es, SMS)
    assert stage == attn_stage_pages(ps, dh, es)
    assert split == attn_split_plan(b, hkv, maxp, SMS, head_chunks(h // hkv))
    assert vec == (dh * es % 16 == 0 and ps * dh * es % 128 == 0)
    assert attn_launch_plan(b, h, hkv, dh, ps, maxp, es, SMS) == \
        (stage, split, vec)


def test_launch_plan_refuses_what_the_kernel_cannot_take():
    with pytest.raises(ValueError, match="d_head"):
        attn_launch_plan(4, 16, 8, 512, 16, 4, 2, SMS)
    with pytest.raises(ValueError, match="shared memory"):
        attn_launch_plan(4, 16, 8, 256, 256, 4, 4, SMS)


def test_split_must_be_a_cluster_size():
    q = torch.zeros(2, 4, 8)
    pages = torch.zeros(3, 4, 2, 8)
    tab = torch.zeros(2, 2, dtype=torch.int32)
    for bad in (0, 3, 16):
        with pytest.raises(ValueError, match="split"):
            paged_decode_attention_cuda(q, pages, pages, tab, 1, split=bad)


def _case(ps, seed, *, b=3, h=4, hkv=2, dh=16, maxp=6, rows=19):
    rng = np.random.default_rng(seed)
    q = rng.standard_normal((b, h, dh)).astype(np.float32)
    kp = rng.standard_normal((rows, ps, hkv, dh)).astype(np.float32)
    vp = rng.standard_normal((rows, ps, hkv, dh)).astype(np.float32)
    kp[-1] = 0                                 # reserved zero row
    vp[-1] = 0
    tab = rng.integers(0, rows - 1, size=(b, maxp)).astype(np.int32)
    tab[1, 2:] = rows - 1                      # partly filled table
    tab[2, :] = rows - 1                       # an empty table
    return q, kp, vp, tab


def _positions(ps, maxp):
    """Scalars and (3,) vectors: one page, page edges, the last token,
    past the table, and ragged slots (one long, the others short)."""
    span = ps * maxp
    return [0, ps - 1, ps, span // 2 + 1, span - 1, span + 7,
            np.asarray([span - 1, 1, ps * 2], np.int32),
            np.asarray([0, span + 5, 3], np.int32)]


@pytest.mark.parametrize("split", [1, 2, 4, 8])
@pytest.mark.parametrize("ps", [4, 8, 16])
def test_split_mirror_matches_pallas_interpret_and_ref_f32(ps, split):
    q, kp, vp, tab = _case(ps, ps)
    jq, jk, jv, jt = (jnp.asarray(x) for x in (q, kp, vp, tab))
    tq, tk, tv, tt = (torch.from_numpy(x) for x in (q, kp, vp, tab))
    for pos in _positions(ps, tab.shape[1]):
        jpos = jnp.asarray(pos, jnp.int32)
        ker = paged_decode_attention_pallas(jq, jk, jv, jt, jpos,
                                            interpret=True)
        ref = jax_ref(jq, jk, jv, jt, jpos)
        mine = paged_decode_attention_split_ref(tq, tk, tv, tt,
                                                torch.as_tensor(pos), split)
        assert mine.shape == q.shape and mine.dtype == torch.float32
        np.testing.assert_allclose(mine.numpy(), np.asarray(ker), **F32,
                                   err_msg=f"pos={pos}")
        np.testing.assert_allclose(mine.numpy(), np.asarray(ref), **F32,
                                   err_msg=f"pos={pos}")


@pytest.mark.parametrize("split", [1, 4, 8])
@pytest.mark.parametrize("ps", [4, 8, 16])
def test_split_mirror_matches_pallas_interpret_and_ref_bf16(ps, split):
    q, kp, vp, tab = _case(ps, 10 + ps, h=8)
    jq, jk, jv = (jnp.asarray(x, jnp.bfloat16) for x in (q, kp, vp))
    jt = jnp.asarray(tab)
    tq, tk, tv = (tensor_from_numpy(np.asarray(x)) for x in (jq, jk, jv))
    for pos in _positions(ps, tab.shape[1]):
        jpos = jnp.asarray(pos, jnp.int32)
        ker = paged_decode_attention_pallas(jq, jk, jv, jt, jpos,
                                            interpret=True)
        ref = jax_ref(jq, jk, jv, jt, jpos)
        mine = paged_decode_attention_split_ref(
            tq, tk, tv, torch.from_numpy(tab), torch.as_tensor(pos), split)
        assert mine.dtype == torch.bfloat16
        for want in (ker, ref):
            np.testing.assert_allclose(mine.float().numpy(),
                                       np.asarray(want, np.float32), **BF16,
                                       err_msg=f"pos={pos}")


@pytest.mark.parametrize("split", [1, 2, 8])
def test_split_mirror_takes_gqa_groups_and_every_split_alike(split):
    """Query groups of 1, 2, 3 and 7 heads (the kernel's group widths and
    chunks): the mirror equals the gather reference, and a split changes
    the result by f32 order only."""
    for h, hkv in ((2, 2), (4, 2), (6, 2), (14, 2)):
        q, kp, vp, tab = (torch.from_numpy(x)
                          for x in _case(8, h, h=h, hkv=hkv))
        pos = torch.tensor([40, 3, 47], dtype=torch.int32)
        want = paged_decode_attention_cuda(q, kp, vp, tab, pos)
        got = paged_decode_attention_split_ref(q, kp, vp, tab, pos, split)
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F32)
