"""Port parity for the serving loop: ``repro_torch``'s paged
``ServeLoop(device="cpu")``, lockstep and continuous (chunked prefill,
with and without copy-on-write prefix sharing), emits exactly the
greedy tokens, in the same admission order and with the same
preemptions, as ``repro``'s paged ``ServeLoop`` in the same mode with a
Morton ``DotEngine``, on shared weights at the qwen3_1_7b SMOKE width
(f32); in continuous mode the prompt tokens prefilled per step and the
final allocator state are equal too."""
import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax

from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import ServeLoop as JaxServeLoop
from repro.models import DotEngine as JaxEngine
from repro.models import init_model as jax_init_model
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.configs import get_smoke_config
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import DotEngine
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeConfig


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """SMOKE-size torch ops gain nothing from a thread pool, and the
    suite runs several test processes at once: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope="module")
def weights():
    jp = jax_init_model(jax_smoke("qwen3_1_7b"), jax.random.PRNGKey(0))
    return jp, params_from_jax(jax.tree.map(np.asarray, jp), device="cpu")


def _run_both(weights, prompts, max_new, mode="lockstep", late=None,
              backends=(None, None), **sc):
    """Both loops on the same requests.  ``late`` = (iterations,
    prompts): those prompts arrive after that many scheduler
    iterations.  ``backends``: the (reference, port) power backends."""
    jp, tp = weights
    ref = JaxServeLoop(jax_smoke("qwen3_1_7b"), jp,
                       JaxServeConfig(layout="paged", mode=mode, **sc),
                       engine=JaxEngine(schedule="morton"),
                       power_backend=backends[0])
    ref_order = []
    set_phase = ref._set_phase

    def record(req_id, phase):
        if phase == "prefill":
            ref_order.append(req_id)
        set_phase(req_id, phase)

    ref._set_phase = record
    mine = ServeLoop(get_smoke_config("qwen3_1_7b"), tp,
                     ServeConfig(layout="paged", mode=mode, **sc),
                     engine=DotEngine(schedule="morton"),
                     power_backend=backends[1], device="cpu")
    for loop in (ref, mine):
        for r, p in enumerate(prompts):
            loop.submit(r, p)
        if late is not None:
            for _ in range(late[0]):
                loop._iteration_body(max_new)
            for r, p in enumerate(late[1], start=len(prompts)):
                loop.submit(r, p)
    out_ref = ref.run(max_new=max_new)
    out = mine.run(max_new=max_new)
    return (out_ref, ref_order, ref), (out, mine.admitted, mine)


@pytest.mark.parametrize("page_size", [4, 8])
def test_greedy_tokens_and_admission_order_equal_reference(weights,
                                                           page_size):
    """More requests than slots: the queue drains in waves."""
    rng = np.random.default_rng(page_size)
    prompts = [rng.integers(2, 128, size=int(n)).tolist()
               for n in (5, 3, 7, 6, 4)]
    (out_ref, order_ref, _), (out, order, loop) = _run_both(
        weights, prompts, 6, slots=2, cache_len=64, page_size=page_size)
    assert out == out_ref
    assert order == order_ref == [0, 1, 2, 3, 4]
    assert loop.alloc.pages_in_use == 0
    loop.alloc.check_invariants()


def test_pool_pressure_preempts_like_reference(weights):
    """A pool too small for both slots' growth (as
    tests/test_serve_loop.py's mid-decode exhaustion case): the
    youngest slot is preempted and re-admitted with its full context,
    with the same tokens and order as the reference."""
    prompt = [5, 6, 7, 8]
    (out_ref, order_ref, ref), (out, order, loop) = _run_both(
        weights, [prompt, prompt], 6, slots=2, cache_len=64, page_size=4,
        num_pages=4, eos_id=-1)
    assert loop.preemptions == ref.preemptions > 0
    assert out == out_ref
    assert order == order_ref
    for r in (0, 1):
        assert len(out[r]) == len(prompt) + 6
    assert loop.alloc.pages_in_use == 0


def test_eos_and_head_of_line_blocking_match_reference(weights):
    """One-request pool: the second admission waits for the first to
    release its pages; an EOS token id that occurs stops requests."""
    prompts = [list(range(2, 10)), list(range(20, 28))]
    (out_ref, order_ref, _), (out, order, loop) = _run_both(
        weights, prompts, 4, slots=2, cache_len=64, page_size=4,
        num_pages=3, eos_id=-1)
    assert out == out_ref and order == order_ref
    assert loop.alloc.stats["reused"] > 0
    first = out[0][len(prompts[0])]
    (out_ref, _, _), (out, _, _) = _run_both(
        weights, prompts, 4, slots=2, cache_len=64, page_size=4,
        eos_id=first)
    assert out == out_ref
    assert out[0] == prompts[0] + [first]


def test_unported_modes_and_layouts_raise(weights):
    """Both layouts are ported (contiguous the default, as in the
    reference); an unknown mode or layout name raises, and so does a
    prompt larger than the whole page pool."""
    from repro_torch.serve import KVLayout
    assert ServeConfig().layout is KVLayout.CONTIGUOUS
    assert ServeConfig(layout="paged").paged
    with pytest.raises(ValueError, match="mode"):
        ServeConfig(mode="speculative")
    with pytest.raises(ValueError, match="ring"):
        ServeConfig(layout="ring")
    _, tp = weights
    loop = ServeLoop(get_smoke_config("qwen3_1_7b"), tp,
                     ServeConfig(layout="paged", page_size=4, num_pages=2),
                     device="cpu")
    loop.submit(0, list(range(2, 14)))       # 12 tokens > 8-token pool
    with pytest.raises(RuntimeError, match="exceeds the whole page pool"):
        loop.run(max_new=2)


def test_continuous_mode_runs(weights):
    """``mode="continuous"`` is ported: it serves every request in
    prefill chunks within the budget, and the CLI takes it."""
    _, tp = weights
    loop = ServeLoop(get_smoke_config("qwen3_1_7b"), tp,
                     ServeConfig(layout="paged", mode="continuous",
                                 page_size=4, prefill_budget=3),
                     device="cpu")
    prompts = [list(range(2, 9)), list(range(20, 25))]
    for r, p in enumerate(prompts):
        loop.submit(r, p)
    out = loop.run(max_new=3)
    assert [len(out[r]) for r in (0, 1)] == [10, 8]
    assert loop.chunk_steps == sum(1 for n in loop.prefill_tokens_per_step
                                   if n) >= 4
    assert max(loop.prefill_tokens_per_step) <= 3
    assert loop.alloc.pages_in_use == 0
    from repro_torch.launch.serve import main
    cli = main(["--arch", "qwen3_1_7b", "--smoke", "--device", "cpu",
                "--mode", "continuous", "--prefill-budget", "5",
                "--requests", "2", "--max-new", "2",
                "--no-prefix-sharing"])
    assert all(len(v) == 8 + 2 for v in cli.values())


# ------------------------------------------------------------ continuous --
SHARED = [9, 8, 7, 6, 5, 4, 3, 2]      # two 4-token pages, one 8-token


def _shared_prompts():
    """A page-aligned shared prefix with ragged tails, an identical
    duplicate (cloned while its source decodes), the bare prefix (served
    from the index alone) and an unrelated prompt."""
    return [SHARED + [11, 12, 13], SHARED + [21], SHARED + [11, 12, 13],
            list(SHARED), [40, 41, 42, 43, 44, 45, 46], SHARED + [31, 32]]


def _final_state(alloc):
    """The allocator's state_dict.  Where the reference's
    PrefixIndex.edges raises (an edge orphaned by its parent's eviction,
    ROADMAP.md queue C), its index's reachable edges stand in, which is
    what the port's edges() lists."""
    try:
        return alloc.state_dict()
    except KeyError:
        index, alloc.index = alloc.index, None
        try:
            d = alloc.state_dict()
        finally:
            alloc.index = index
        parent_of = {id(index._root): -1}
        for pid, children in index._children.items():
            parent_of[id(children)] = pid
        d["index"] = [[parent_of[id(children)], list(key), int(pid)]
                      for pid, (children, key) in index._owner.items()
                      if id(children) in parent_of]
        return d


@pytest.mark.parametrize("sharing", [True, False])
@pytest.mark.parametrize("page_size,budget", [(4, 4), (8, 3)])
def test_continuous_equals_reference(weights, sharing, page_size, budget):
    """Continuous batching over shared prefixes, more requests than
    slots: three prompts at the start, three more once the first one
    decodes (its duplicate clones its table and forks the shared tail
    page on its first write; the bare prefix is adopted from the index,
    live or revived).  Tokens, admission order, prompt tokens per step,
    preemptions and the final allocator state equal the reference's."""
    first, *rest = _shared_prompts()
    initial = [first, rest[0], rest[3]]
    late = [rest[1], rest[2], rest[4]]
    decoding = -(-len(first) // budget) + 1     # iterations until it decodes
    (out_ref, order_ref, ref), (out, order, loop) = _run_both(
        weights, initial, 5, mode="continuous", late=(decoding, late),
        slots=4, cache_len=48, page_size=page_size, prefill_budget=budget,
        prefix_sharing=sharing)
    assert out == out_ref
    assert order == order_ref
    assert loop.prefill_tokens_per_step == ref.prefill_tokens_per_step
    assert max(loop.prefill_tokens_per_step) <= budget
    assert loop.preemptions == ref.preemptions
    assert _final_state(loop.alloc) == _final_state(ref.alloc)
    st = loop.alloc.stats
    assert (st["prefix_hits"] > 0 and st["cow_forks"] > 0) == sharing
    assert out[3] == out[0]                   # the duplicate's tokens
    loop.alloc.check_invariants()


def test_continuous_pool_pressure_preempts_like_reference(weights):
    """A pool too small for both slots: a mid-prefill or decoding slot
    is preempted and re-admitted with its full context, as in the
    reference."""
    prompts = [list(range(2, 11)), list(range(20, 29)), [5, 6, 7]]
    (out_ref, order_ref, ref), (out, order, loop) = _run_both(
        weights, prompts, 6, mode="continuous", slots=2, cache_len=64,
        page_size=4, num_pages=5, prefill_budget=3, eos_id=-1)
    assert loop.preemptions == ref.preemptions > 0
    assert out == out_ref and order == order_ref
    assert loop.prefill_tokens_per_step == ref.prefill_tokens_per_step
    assert _final_state(loop.alloc) == _final_state(ref.alloc)
    loop.alloc.check_invariants()


def test_continuous_matches_lockstep_and_sharing_off(weights):
    """Within the port: lockstep, continuous with prefix sharing and
    continuous without it emit the same greedy tokens."""
    _, tp = weights
    outs = []
    for mode, sharing in (("lockstep", True), ("continuous", True),
                          ("continuous", False)):
        loop = ServeLoop(get_smoke_config("qwen3_1_7b"), tp,
                         ServeConfig(slots=2, cache_len=64, page_size=4,
                                     layout="paged", mode=mode,
                                     prefill_budget=4,
                                     prefix_sharing=sharing), device="cpu")
        for r, p in enumerate(_shared_prompts()):
            loop.submit(r, p)
        outs.append(loop.run(max_new=4))
        loop.alloc.check_invariants()
    assert outs[0] == outs[1] == outs[2]


def _continuous_loop(weights, budget=16):
    _, tp = weights
    return ServeLoop(get_smoke_config("qwen3_1_7b"), tp,
                     ServeConfig(slots=2, cache_len=64, page_size=4,
                                 layout="paged", mode="continuous",
                                 prefill_budget=budget),
                     device="cpu")


def _drive_until_active(loop, steps=64):
    for _ in range(steps):
        loop._admit_continuous()
        loop.prefill_tokens_per_step.append(loop._prefill_step())
        if loop.active.any():
            return
    raise AssertionError("no slot became active")


def test_cow_fork_on_first_write_non_aligned_tail(weights):
    """A clone whose first decode write lands inside a shared partial
    tail page forks a private copy first, and both streams emit the same
    greedy tokens (identical prompts); tests/test_serve_continuous.py's
    case of the same name."""
    prompt = [5, 6, 7, 8, 9]             # 5 tokens: page 1 is a partial tail
    loop = _continuous_loop(weights)
    loop.submit(0, prompt)
    _drive_until_active(loop)
    loop._decode_once(max_new=6)         # slot 0 decodes past the prompt
    loop.submit(1, prompt)               # identical prompt, mid-flight
    loop._admit_continuous()             # -> whole-table clone, no prefill
    assert loop.alloc.stats["shared_pages"] > 0
    assert loop.active.all()
    before = loop.alloc.stats["cow_forks"]
    out = loop.run(max_new=6)
    assert loop.alloc.stats["cow_forks"] > before
    assert out[1] == out[0]
    loop.alloc.check_invariants()


def test_no_fork_at_page_aligned_boundary(weights):
    """A clone whose shared prefix ends on a page boundary writes its
    first token into a fresh page: no fork; tests/test_serve_continuous
    .py's case of the same name."""
    prompt = [5, 6, 7, 8, 9, 10, 11, 12]  # 8 tokens: two full pages
    loop = _continuous_loop(weights)
    loop.submit(0, prompt)
    _drive_until_active(loop)
    loop.submit(1, prompt)
    loop._admit_continuous()
    assert loop.alloc.stats["shared_pages"] == 2
    out = loop.run(max_new=4)
    assert loop.alloc.stats["cow_forks"] == 0
    assert out[1] == out[0]
    loop.alloc.check_invariants()


# ---------------------------------------------------------------- energy --
class HintsBackend:
    """A deterministic power backend for either package: joules from the
    metered region's WorkloadHints alone (never from time), and a record
    of every region's hints."""

    name = "hints"
    primary_domains = ("j",)

    def __init__(self):
        self.hints = []

    def start(self):
        return None

    def stop(self, token, elapsed_s, hints=None):
        self.hints.append(hints)
        return {"j": 1e-12 * hints.flops + 1e-10 * hints.hbm_bytes
                + 1e-9 * hints.attn_bytes + 0.1 * hints.f_scale}


def _hint_dicts(backend):
    return [{f: getattr(h, f) for f in ("flops", "hbm_bytes", "ici_bytes",
                                        "dcn_bytes", "chips", "f_scale",
                                        "hw", "attn_bytes", "gemm_bytes")}
            for h in backend.hints]


@pytest.mark.parametrize("mode,sharing,objective", [
    ("lockstep", False, None), ("continuous", True, None),
    ("continuous", False, None), ("continuous", True, "edp"),
    ("lockstep", False, "edp")])
def test_energy_accounting_equals_reference(weights, tmp_path, monkeypatch,
                                            mode, sharing, objective):
    """Every prefill, prefill chunk and decode step is metered with the
    reference's WorkloadHints, in the same order and under the same
    labels; the report's meta (the latency summary's keys; its values
    are wall clocks),
    ``request_joules`` and, under ``objective="edp"``, the tuned DVFS
    points equal the reference's; the greedy tokens are unchanged.  The
    tuner cache is shared: the reference's loop resolves first and the
    port reads its winners (the reference's constants live there)."""
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "tune.json"))
    first, *rest = _shared_prompts()
    ref_be, my_be = HintsBackend(), HintsBackend()
    kw = dict(slots=4, cache_len=48, page_size=4, prefill_budget=4,
              prefix_sharing=sharing, objective=objective)
    late = (-(-len(first) // 4) + 1, [rest[1], rest[2]]) \
        if mode == "continuous" else None
    (out_ref, _, ref), (out, _, loop) = _run_both(
        weights, [first, rest[0], rest[3]], 4, mode=mode, late=late,
        backends=(ref_be, my_be), **kw)
    assert out == out_ref
    assert _hint_dicts(my_be) == _hint_dicts(ref_be)
    labels = [r.label for r in loop.energy.readings]
    assert labels == [r.label for r in ref.energy.readings]
    assert set(labels) == ({"prefill", "decode-step"} if mode == "lockstep"
                           else {"prefill-chunk", "decode-step"})
    meta_ref = {k: v for k, v in ref.energy.meta.items() if k != "latency"}
    assert {k: v for k, v in loop.energy.meta.items()
            if k != "latency"} == meta_ref
    lat, lat_ref = loop.energy.meta["latency"], ref.energy.meta["latency"]
    assert {k: sorted(v) for k, v in lat.items()} == \
        {k: sorted(v) for k, v in lat_ref.items()}
    assert loop.energy.backend == "hints"
    assert loop.request_joules.keys() == ref.request_joules.keys()
    for r, j in ref.request_joules.items():
        assert loop.request_joules[r] == pytest.approx(j, rel=1e-12)
    total = loop.energy.totals()["joules"]
    assert sum(loop.request_joules.values()) == pytest.approx(total,
                                                              rel=1e-9)
    assert loop.f_scales == ref.f_scales
    assert loop.f_scale == ref.f_scale
    if objective:
        assert loop.objective == objective
        assert loop.engine.objective == objective
    if sharing and mode == "continuous":
        assert loop.energy.meta["attn_share"] < 1.0
