"""Port parity for the serving loop: ``repro_torch``'s lockstep paged
``ServeLoop(device="cpu")`` emits exactly the greedy tokens, in the
same admission order and with the same preemptions, as ``repro``'s
lockstep paged ``ServeLoop`` with a Morton ``DotEngine``, on shared
weights at the qwen3_1_7b SMOKE width (f32)."""
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


def _run_both(weights, prompts, max_new, **sc):
    jp, tp = weights
    ref = JaxServeLoop(jax_smoke("qwen3_1_7b"), jp,
                       JaxServeConfig(layout="paged", mode="lockstep", **sc),
                       engine=JaxEngine(schedule="morton"))
    ref_order = []
    set_phase = ref._set_phase

    def record(req_id, phase):
        if phase == "prefill":
            ref_order.append(req_id)
        set_phase(req_id, phase)

    ref._set_phase = record
    mine = ServeLoop(get_smoke_config("qwen3_1_7b"), tp,
                     ServeConfig(layout="paged", mode="lockstep", **sc),
                     engine=DotEngine(schedule="morton"), device="cpu")
    for loop in (ref, mine):
        for r, p in enumerate(prompts):
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
    with pytest.raises(NotImplementedError, match="continuous"):
        ServeConfig(mode="continuous")
    with pytest.raises(NotImplementedError, match="contiguous"):
        ServeConfig(layout="contiguous")
    _, tp = weights
    loop = ServeLoop(get_smoke_config("qwen3_1_7b"), tp,
                     ServeConfig(page_size=4, num_pages=2), device="cpu")
    loop.submit(0, list(range(2, 14)))       # 12 tokens > 8-token pool
    with pytest.raises(RuntimeError, match="exceeds the whole page pool"):
        loop.run(max_new=2)
