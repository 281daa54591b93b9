"""Port parity for the paged KV cache: the same operation sequence on
``repro``'s and ``repro_torch``'s page allocators gives identical block
tables, free lists, refcounts and state_dicts (with prefix sharing: the
cached-free list and the prefix index's edges too); the Morton page
permutation and the physical-row mapping are equal."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax.numpy as jnp

from repro.configs import get_smoke_config as jax_smoke
from repro.serve.paged_kv import PageAllocator as JaxAllocator
from repro.serve.paged_kv import PoolExhausted as JaxPoolExhausted
from repro.serve.paged_kv import init_paged_serving as jax_init_paged_serving
from repro.serve.paged_kv import page_permutation as jax_page_permutation
from repro.serve.paged_kv import physical_rows as jax_physical_rows
from repro_torch.configs import get_smoke_config
from repro_torch.serve.paged_kv import PageAllocator, PoolExhausted, \
    init_paged_serving, page_permutation, physical_rows


def _same(ja, ta):
    assert ta.state_dict() == ja.state_dict()
    np.testing.assert_array_equal(ta.block_table, ja.block_table)
    assert ta.free_pages == ja.free_pages
    assert ta.pages_in_use == ja.pages_in_use
    ta.check_invariants()
    ja.check_invariants()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_random_op_sequence_gives_identical_allocator_state(seed):
    rng = np.random.default_rng(seed)
    num_pages, ps, slots, width = 12, 4, 3, 5
    ja = JaxAllocator(num_pages, ps, slots, width)
    ta = PageAllocator(num_pages, ps, slots, width)
    for _ in range(60):
        op = rng.integers(0, 3)
        s = int(rng.integers(0, slots))
        position = int(rng.integers(0, width * ps))
        length = int(rng.integers(1, 3 * ps))
        outcomes = []
        for alloc, exhausted in ((ja, JaxPoolExhausted), (ta, PoolExhausted)):
            try:
                if op == 0:
                    res = alloc.ensure(s, position)
                elif op == 1:
                    res = alloc.ensure_range(s, length)
                else:
                    res = alloc.release(s)
                outcomes.append(("ok", res))
            except exhausted:
                outcomes.append(("exhausted", None))
            except RuntimeError as e:  # block-table extent
                outcomes.append(("extent", "outgrew" in str(e)))
        assert outcomes[0] == outcomes[1]
        _same(ja, ta)
        for pid in range(num_pages):
            assert ta.was_freed(pid) == ja.was_freed(pid)


def _reachable_edges(index):
    """The reference index's edges whose parent node still exists."""
    parent_of = {id(index._root): -1}
    for pid, children in index._children.items():
        parent_of[id(children)] = pid
    return [[parent_of[id(children)], list(key), int(pid)]
            for pid, (children, key) in index._owner.items()
            if id(children) in parent_of]


def _sharing_op(alloc, exhausted, op, s, other, prompt, tok, toks):
    """One prefix-sharing operation on ``alloc``; ``toks`` holds each
    slot's token contents (this allocator's copy).  Returns what the
    operation returned, or how it failed."""
    try:
        if op == 0:        # admission: adopt what the index holds, fill
            alloc.release(s)
            adopted = alloc.adopt_prefix(s, prompt)
            new = alloc.ensure_range(s, len(prompt))
            toks[s] = list(prompt)
            alloc.register_prefix(s, prompt)
            return "ok", (adopted, new)
        if op == 1:        # one more token: fork a shared page first
            pos = len(toks[s])
            forked = alloc.fork(s, pos) if alloc.needs_fork(s, pos) else None
            new = alloc.ensure(s, pos)
            toks[s].append(tok)
            return "ok", (forked, new)
        if op == 2:
            toks[s] = []
            return "ok", alloc.release(s)
        if op == 3:        # whole-table clone into a released slot
            alloc.release(other)
            toks[other] = list(toks[s])
            return "ok", alloc.clone_table(s, other)
        alloc.register_prefix(s, toks[s])
        return "ok", None
    except exhausted:
        return "exhausted", None
    except RuntimeError as e:  # block-table extent
        return "extent", "outgrew" in str(e)


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_prefix_sharing_op_sequence_gives_identical_state(seed):
    """Adopt, register, clone, fork, grow and release on a pool small
    enough that zero-ref indexed pages park on the cached FIFO, are
    revived by later admissions and are evicted from it when the plain
    pool runs dry: outcomes and state_dicts (index edges included) stay
    equal to the reference's after every operation."""
    rng = np.random.default_rng(seed)
    num_pages, ps, slots, width = 10, 2, 3, 6
    ja = JaxAllocator(num_pages, ps, slots, width, prefix_sharing=True)
    ta = PageAllocator(num_pages, ps, slots, width, prefix_sharing=True)
    bases = [[5, 6, 7, 8], [5, 6, 9, 9], [3, 4]]
    jt, tt = [[] for _ in range(slots)], [[] for _ in range(slots)]
    evicted = 0
    for _ in range(120):
        op = int(rng.choice(5, p=[0.3, 0.3, 0.15, 0.1, 0.15]))
        s, other = (int(x) for x in rng.choice(slots, 2, replace=False))
        base = bases[int(rng.integers(len(bases)))]
        prompt = base + rng.integers(2, 4, size=int(rng.integers(0, 4))).tolist()
        tok = int(rng.integers(2, 9))
        before = set(ta.index._owner)
        got = [_sharing_op(ja, JaxPoolExhausted, op, s, other, prompt, tok,
                           jt),
               _sharing_op(ta, PoolExhausted, op, s, other, prompt, tok, tt)]
        assert got[0] == got[1]
        assert jt == tt
        try:
            _same(ja, ta)
        except KeyError:
            # the reference's PrefixIndex.edges raises while an evicted
            # parent has indexed children (ROADMAP.md queue C): hold the
            # rest of the state, and the port's edges to the reachable
            # ones of the reference's index
            index, ja.index = ja.index, None
            want = ja.state_dict()
            ja.index = index
            mine = ta.state_dict()
            assert mine.pop("index") == _reachable_edges(index)
            want.pop("index")
            assert mine == want
            ta.check_invariants()
            ja.check_invariants()
        evicted += len(before - set(ta.index._owner))
    st = ta.stats
    assert st["prefix_hits"] and st["revived"] and st["cow_forks"] \
        and st["shared_pages"] and evicted
    assert ta.state_dict()["index"]


def test_lifo_reuse_and_scrub_flags_match():
    ja, ta = JaxAllocator(8, 4, 2), PageAllocator(8, 4, 2)
    for alloc in (ja, ta):
        alloc.ensure_range(0, 10)
        alloc.ensure_range(1, 5)
        alloc.release(0)
        alloc.ensure_range(0, 7)
    _same(ja, ta)
    assert ta.stats["reused"] == ja.stats["reused"] > 0


def test_invariant_audit_names_corruption():
    ta = PageAllocator(4, 4, 2)
    ta.ensure_range(0, 8)
    ta.ref[ta.block_table[0, 0]] = 2
    with pytest.raises(RuntimeError, match="refcount 2 != 1"):
        ta.check_invariants()
    tb = PageAllocator(4, 4, 2)
    tb._free.append(tb._free[-1])
    with pytest.raises(RuntimeError, match="double-free"):
        tb.check_invariants()


@pytest.mark.parametrize("n_layers,num_pages", [(2, 8), (28, 16), (3, 5),
                                                (1, 1)])
def test_page_permutation_equals_reference(n_layers, num_pages):
    np.testing.assert_array_equal(page_permutation(n_layers, num_pages),
                                  jax_page_permutation(n_layers, num_pages))


def test_physical_rows_equal_reference_both_orientations():
    perm = jax_page_permutation(3, 6)
    zero = 3 * 6
    bt = np.asarray([[4, -1, 0], [-1, -1, 5]], np.int32)
    ref_all = np.asarray(jax_physical_rows(jnp.asarray(perm),
                                           jnp.asarray(bt), zero))
    mine_all = physical_rows(torch.from_numpy(perm), torch.from_numpy(bt),
                             zero)
    assert mine_all.shape == (3, 2, 3) and mine_all.dtype == torch.int32
    np.testing.assert_array_equal(mine_all.numpy(), ref_all)
    ref_one = np.asarray(jax_physical_rows(jnp.asarray(perm[1]),
                                           jnp.asarray(bt), zero))
    np.testing.assert_array_equal(
        physical_rows(torch.from_numpy(perm[1]), torch.from_numpy(bt),
                      zero).numpy(), ref_one)


@pytest.mark.parametrize("kw", [dict(), dict(num_pages=7),
                                dict(max_pages_per_slot=3)])
def test_init_paged_serving_matches_reference_geometry(kw):
    ja, js = jax_init_paged_serving(jax_smoke("qwen3_1_7b"), 3, 24,
                                    page_size=4, **kw)
    ta, ts = init_paged_serving(get_smoke_config("qwen3_1_7b"), 3, 24,
                                page_size=4, device="cpu", **kw)
    assert (ta.num_pages, ta.max_pages_per_slot) == \
        (ja.num_pages, ja.max_pages_per_slot)
    for key in ("k_pages", "v_pages", "page_perm", "block_tables"):
        assert tuple(ts[key].shape) == tuple(js[key].shape), key
        np.testing.assert_array_equal(ts[key].numpy(), np.asarray(js[key]))
    assert ts.layout.is_paged
