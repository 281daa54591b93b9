"""Port parity for the four dense archs (qwen3-1.7b, glm4-9b,
deepseek-coder-33b and h2o-danube-3-4b, the last with a 32-token
sliding window at SMOKE size): their configs field by field, the
parameter tree, and the greedy tokens of ``repro_torch``'s contiguous
``ServeLoop(device="cpu")`` against ``repro``'s on shared weights
(``params_from_jax``, f32), lockstep and, where there is no window,
continuous; paged against contiguous tokens within the port; and the
SWA ring under staggered admissions.

The reference keeps an SWA arch on one shared position, the oldest live
slot's, so in a staggered mix a request admitted later decodes at
another request's position and reads ring entries it never wrote (the
previous occupant's K/V, marked valid by the shared ``kv_pos``).  Its
tokens are compared with the port's only on traffic where that position
is every live slot's own: all requests admitted together with equal
prompt lengths, or one slot.  ``test_swa_staggered_mix_equals_alone``
shows the fault (ROADMAP.md queue C) and holds the port to a request's
tokens alone.  Tokens are exact."""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import ServeLoop as JaxServeLoop
from repro.models import DotEngine as JaxEngine
from repro.models import init_model as jax_init_model
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.launch.serve import ServeLoop
from repro_torch.models import DotEngine, init_model
from repro_torch.models.convert import params_from_jax
from repro_torch.serve import ServeConfig

DENSE = ["qwen3_1_7b", "glm4_9b", "deepseek_coder_33b", "h2o_danube_3_4b"]
FULL_ATTENTION = DENSE[:3]
NEW = DENSE[1:]


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """SMOKE-size torch ops gain nothing from a thread pool, and the
    suite runs several test processes at once: one intra-op thread."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_WEIGHTS = {}


def _weights(arch):
    if arch not in _WEIGHTS:
        jp = jax_init_model(jax_smoke(arch), jax.random.PRNGKey(0))
        _WEIGHTS[arch] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                              device="cpu"))
    return _WEIGHTS[arch]


def _ref_loop(arch, **sc):
    jp, _ = _weights(arch)
    return JaxServeLoop(jax_smoke(arch), jp, JaxServeConfig(**sc),
                        engine=JaxEngine(schedule="morton"))


def _port_loop(arch, **sc):
    _, tp = _weights(arch)
    return ServeLoop(get_smoke_config(arch), tp, ServeConfig(**sc),
                     engine=DotEngine(schedule="morton"), device="cpu")


def _serve(loop, requests, max_new):
    for r, p in requests:
        loop.submit(r, p)
    return loop.run(max_new=max_new)


def _prompts(lens, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).tolist() for n in lens]


@pytest.mark.parametrize("arch", NEW)
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_configs_equal_reference_field_by_field(arch, which):
    get_t, get_j = {"config": (get_config, jax_config),
                    "smoke": (get_smoke_config, jax_smoke)}[which]
    mine, ref = get_t(arch), get_j(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    assert mine.padded_vocab == ref.padded_vocab
    assert mine.params_count() == ref.params_count()
    assert get_t(arch.replace("_", "-")) == mine


def test_registry_holds_the_dense_archs_and_names_the_rest():
    assert ARCHS[:4] == DENSE
    for arch in ("llava_next_34b", "hubert_xlarge"):
        with pytest.raises(KeyError, match="ROADMAP"):
            get_config(arch)


@pytest.mark.parametrize("arch", NEW)
def test_init_model_tree_matches_reference(arch):
    jp, _ = _weights(arch)
    mine = init_model(get_smoke_config(arch),
                      torch.Generator().manual_seed(0), device="cpu")
    flat_j = jax.tree_util.tree_flatten_with_path(jp)[0]
    got = {jax.tree_util.keystr(k): tuple(v.shape) for k, v in flat_j}
    want = {}

    def walk(tree, path):
        for k, v in tree.items():
            if isinstance(v, dict):
                walk(v, path + f"['{k}']")
            else:
                want[path + f"['{k}']"] = tuple(v.shape)

    walk(mine, "")
    assert want == got


@pytest.mark.parametrize("mode", ["lockstep", "continuous"])
@pytest.mark.parametrize("arch", FULL_ATTENTION)
def test_contiguous_tokens_equal_reference(arch, mode):
    """Five ragged prompts through 2 slots (the queue drains in waves),
    contiguous strips of 64: the same greedy tokens and admission order
    as the reference's contiguous loop."""
    sc = dict(slots=2, cache_len=64, mode=mode, prefill_budget=5, eos_id=-1)
    reqs = list(enumerate(_prompts((5, 3, 7, 6, 4), seed=1)))
    ref, mine = _ref_loop(arch, **sc), _port_loop(arch, **sc)
    want = _serve(ref, reqs, 6)
    assert _serve(mine, reqs, 6) == want
    assert mine.alloc is None and mine.attn_spec.tag() == "contig"
    if mode == "continuous":
        assert mine.prefill_tokens_per_step == ref.prefill_tokens_per_step


@pytest.mark.parametrize("traffic", ["together", "one_slot"])
def test_swa_tokens_equal_reference_where_it_is_sound(traffic):
    """h2o SMOKE (window 32, cache_len 64: a ring of 32 entries), prompts
    and generations past the window.  ``together``: three 20-token
    prompts admitted at once into 3 slots, 24 new tokens each (positions
    to 43).  ``one_slot``: a 40-token prompt (its prefill wraps the ring)
    and a 12-token one, one after the other through 1 slot."""
    if traffic == "together":
        sc = dict(slots=3, cache_len=64, eos_id=-1)
        reqs = list(enumerate(_prompts((20, 20, 20), seed=2)))
    else:
        sc = dict(slots=1, cache_len=64, eos_id=-1)
        reqs = list(enumerate(_prompts((40, 12), seed=3)))
    want = _serve(_ref_loop("h2o_danube_3_4b", **sc), reqs, 24)
    got = _serve(_port_loop("h2o_danube_3_4b", **sc), reqs, 24)
    assert got == want
    assert all(len(want[r]) == len(p) + 24 for r, p in reqs)


def test_swa_staggered_mix_equals_alone():
    """h2o SMOKE, 2 slots, cache_len 64, prompts of 20, 9 and 14 tokens,
    24 new: request 2 is admitted when request 0 or 1 retires, so slots
    sit at different positions.  In the port each request's tokens in
    the mix equal its tokens alone; in the reference (shared scalar
    position) at least one request's do not."""
    sc = dict(slots=2, cache_len=64)
    prompts = _prompts((20, 9, 14), seed=0)
    reqs = list(enumerate(prompts))
    for make, sound in ((_port_loop, True), (_ref_loop, False)):
        mix = _serve(make("h2o_danube_3_4b", **sc), reqs, 24)
        alone = {r: _serve(make("h2o_danube_3_4b", **sc), [(r, p)], 24)[r]
                 for r, p in reqs}
        same = [mix[r] == alone[r] for r, _ in reqs]
        assert all(same) if sound else not all(same), (make.__name__, same)


@pytest.mark.parametrize("mode", ["lockstep", "continuous"])
@pytest.mark.parametrize("arch", FULL_ATTENTION)
def test_paged_tokens_equal_contiguous(arch, mode):
    """Within the port: the paged pool (pages of 4) and the contiguous
    strips give the same greedy tokens for the same requests."""
    reqs = list(enumerate(_prompts((9, 4, 12, 7), seed=4)))
    outs = [_serve(_port_loop(arch, slots=2, cache_len=64, mode=mode,
                              layout=layout, page_size=4, prefill_budget=6,
                              eos_id=-1), reqs, 8)
            for layout in ("paged", "contiguous")]
    assert outs[0] == outs[1]


def test_swa_needs_the_contiguous_lockstep_loop():
    """A ring has no pages and no chunked prefill: the paged layout and
    continuous mode raise for h2o, as in the reference."""
    with pytest.raises(ValueError, match="SWA"):
        _port_loop("h2o_danube_3_4b", layout="paged")
    with pytest.raises(ValueError, match="SWA"):
        _port_loop("h2o_danube_3_4b", mode="continuous")
    assert _port_loop("h2o_danube_3_4b").state["k"].shape[2] == 32
