"""Port parity for the frontend archs, hubert-xlarge (encoder: frame
features through ``frontend_proj``, bidirectional, no decode step) and
llava-next-34b (vlm: projected CLIP patches in place of the first
positions, a ``loss_mask`` over them; decodes and serves as dense), on
the CPU against ``repro`` on shared weights (``params_from_jax``, f32)
and numpy-seeded inputs: configs field by field, ``make_batch`` bit for
bit (the full configs' bf16 features and vision embeddings too), the
parameter tree, ``forward``/``loss_fn`` and every gradient leaf, the
encoder's unread ``embed`` (a zero gradient that AdamW still decays),
train steps' parameters, the GEMM counts of a train step, llava's
decode against its full-sequence forward and its greedy tokens through
``ServeLoop`` in both layouts and both modes, the encoder's refusals and
both CLIs, and ``layers.layer_norm``.

Tolerances (f32 SMOKE configs, as ``tests/test_torch_archs_families.py``
and ``tests/test_torch_train.py`` hold the other families): logits
within 2e-5 absolute; the loss and ``ce`` within 1e-5 relative; every
gradient leaf within 1e-4 of its largest magnitude; a decode step's
logits within 2e-5 and its state within 1e-5; three ``make_train_step``
steps' losses and gradient norms within 1e-5 relative and the final
parameters within 1e-4 absolute but for at most one element in a
thousand, and those within 2 lr a step (Adam's normalised step turns an
f32 rounding difference of a tiny gradient into a difference of up to
2 lr: hubert's SMOKE step moves one of 16384 MLP weights 3.5e-4 apart);
decode against the full forward within 2e-3 (the reference's own
``test_decode_matches_prefill`` bound: the q-chunked causal softmax
against one position at a time); ``layer_norm`` within 1e-6 in f32 and
one bf16 rounding step (2**-7 relative) in bf16; batches and tokens
exact.
"""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp

from repro.configs import get_config as jax_config
from repro.configs import get_smoke_config as jax_smoke
from repro.launch.serve import ServeLoop as JaxServeLoop
from repro.launch.steps import make_train_step as ref_make_train_step
from repro.models import DotEngine as JaxEngine
from repro.models import init_model as jax_init_model
from repro.models.config import ShapeSpec as RefShapeSpec
from repro.models.frontends import make_batch as ref_make_batch
from repro.models.layers import layer_norm as ref_layer_norm
from repro.models.transformer import decode_step as ref_decode_step
from repro.models.transformer import forward as ref_forward
from repro.models.transformer import init_decode_state as ref_init_state
from repro.models.transformer import loss_fn as ref_loss_fn
from repro.models.transformer import prefill_kv as ref_prefill_kv
from repro.optim import AdamWConfig as RefAdamWConfig
from repro.optim.adamw import init_opt_state as ref_init_opt_state
from repro.serve import ServeConfig as JaxServeConfig
from repro_torch.configs import ARCHS, get_config, get_smoke_config
from repro_torch.kernels import ops
from repro_torch.launch.serve import ServeLoop
from repro_torch.launch.serve import main as serve_main
from repro_torch.launch.steps import grads_of, make_train_step
from repro_torch.models import DotEngine, decode_step, forward, \
    init_decode_state, init_model, make_batch, prefill_kv, prefill_kv_chunk
from repro_torch.models.config import ShapeSpec
from repro_torch.models.convert import params_from_jax
from repro_torch.models.layers import layer_norm
from repro_torch.optim import AdamWConfig, init_opt_state
from repro_torch.optim.adamw import tree_leaves
from repro_torch.serve import ServeConfig

FRONTENDS = ["hubert_xlarge", "llava_next_34b"]
ENCODER, VLM = FRONTENDS
REF_ENGINE = JaxEngine(schedule="morton")
# B1 GEMMs a layer of the forward: the attention's 4 and the MLP's 3
LAYER_GEMMS = 7


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def count_gemms(monkeypatch):
    """Counts calls of the GEMM kernel wrapper (the CPU runs its plain
    version, which the launch counter does not count)."""
    calls = [0]
    inner = ops.sfc_matmul_cuda

    def counted(*a, **kw):
        calls[0] += 1
        return inner(*a, **kw)

    monkeypatch.setattr(ops, "sfc_matmul_cuda", counted)
    return calls


_WEIGHTS = {}


def _weights(arch):
    if arch not in _WEIGHTS:
        jp = jax_init_model(jax_smoke(arch), jax.random.PRNGKey(0))
        _WEIGHTS[arch] = (jp, params_from_jax(jax.tree.map(np.asarray, jp),
                                              device="cpu"))
    return _WEIGHTS[arch]


def _batches(arch, b=2, s=32, seed=1):
    """The reference's ``make_batch`` (jax arrays) and the same arrays as
    torch tensors."""
    jb = ref_make_batch(jax_smoke(arch), RefShapeSpec("t", s, b, "train"),
                        seed=seed)
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _leaf_errors(got_tree, want_tree, rel):
    flat = jax.tree_util.tree_flatten_with_path(want_tree)[0]
    leaves = tree_leaves(got_tree)
    assert len(flat) == len(leaves)
    for (path, want), got in zip(flat, leaves):
        want = np.asarray(want, np.float32)
        assert tuple(got.shape) == want.shape, jax.tree_util.keystr(path)
        scale = max(float(np.abs(want).max()), 1e-30)
        err = float(np.abs(got.float().numpy() - want).max())
        assert err <= rel * scale, (jax.tree_util.keystr(path), err, scale)


def _prompts(lens, seed=0, vocab=128):
    rng = np.random.default_rng(seed)
    return [rng.integers(2, vocab, size=n).tolist() for n in lens]


def _serve(loop, requests, max_new):
    for r, p in requests:
        loop.submit(r, p)
    return loop.run(max_new=max_new)


def _bits(t: torch.Tensor) -> np.ndarray:
    """A bf16 tensor's 16-bit patterns."""
    return t.view(torch.int16).numpy().view(np.uint16)


# ------------------------------------------------------------- configs --
@pytest.mark.parametrize("arch", FRONTENDS)
@pytest.mark.parametrize("which", ["config", "smoke"])
def test_configs_equal_reference_field_by_field(arch, which):
    get_t, get_j = {"config": (get_config, jax_config),
                    "smoke": (get_smoke_config, jax_smoke)}[which]
    mine, ref = get_t(arch), get_j(arch)
    assert dataclasses.asdict(mine) == dataclasses.asdict(ref)
    for prop in ("padded_vocab", "has_attention", "has_ssm", "has_decode",
                 "subquadratic"):
        assert getattr(mine, prop) == getattr(ref, prop), prop
    assert mine.runnable_shapes() == ref.runnable_shapes()
    assert mine.params_count() == ref.params_count()
    assert get_t(arch.replace("_", "-")) == mine
    assert arch in ARCHS


def test_every_reference_arch_is_registered():
    from repro.configs import ARCHS as REF_ARCHS
    assert sorted(ARCHS) == sorted(REF_ARCHS)
    for arch in REF_ARCHS:
        assert dataclasses.asdict(get_config(arch)) == \
            dataclasses.asdict(jax_config(arch))


# ---------------------------------------------------------- make_batch --
@pytest.mark.parametrize("seed", [0, 7])
@pytest.mark.parametrize("which", ["smoke", "config"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_make_batch_equals_reference_bit_for_bit(arch, which, seed):
    """Every array of the batch: the same keys, shapes and dtypes, and
    the same values bit for bit (the full configs' features and vision
    embeddings in bf16, from f64 draws rounded through f32 as the
    reference's cast does).  The vlm's 40-token rows put nv =
    min(frontend_tokens, 20) patches in front (20 at full size, 8 at
    SMOKE size)."""
    get_t, get_j = {"config": (get_config, jax_config),
                    "smoke": (get_smoke_config, jax_smoke)}[which]
    want = ref_make_batch(get_j(arch), RefShapeSpec("t", 40, 3, "train"),
                          seed=seed)
    got = make_batch(get_t(arch), ShapeSpec("t", 40, 3, "train"), seed=seed)
    assert set(got) == set(want)
    for k, w in want.items():
        w = np.asarray(w)
        g = got[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype)[6:] == str(w.dtype), k
        if g.dtype == torch.bfloat16:
            np.testing.assert_array_equal(_bits(g), w.view(np.uint16))
        else:
            np.testing.assert_array_equal(g.numpy(), w)
    if arch == VLM:
        nv = min(get_t(arch).frontend_tokens, 20)
        assert got["vision_embeds"].shape[1] == nv
        assert float(got["loss_mask"][:, :nv].sum()) == 0.0
        assert bool((got["loss_mask"][:, nv:] == 1.0).all())


def test_make_batch_rounds_through_f32_like_the_reference():
    """A value whose f64 -> bf16 rounding differs from f64 -> f32 ->
    bf16 (1 + 2**-8 + 2**-40: f32 lands on the tie, which rounds to
    even): the port's draw takes the reference's two steps."""
    from repro_torch.models.frontends import _normal

    x = np.array([1 + 2.0 ** -8 + 2.0 ** -40])
    want = np.asarray(jnp.asarray(x, dtype=jnp.bfloat16)).view(np.uint16)

    class Rng:
        def standard_normal(self, shape):
            return x.reshape(shape)

    real = np.random.default_rng
    np.random.default_rng = lambda seed: Rng()
    try:
        got = _normal((1,), 0, torch.bfloat16, "cpu")
    finally:
        np.random.default_rng = real
    np.testing.assert_array_equal(_bits(got), want)
    assert float(got) == 1.0


# ---------------------------------------------------------------- init --
@pytest.mark.parametrize("arch", FRONTENDS)
def test_init_model_tree_matches_reference(arch):
    """The same leaves, shapes and dtypes, ``frontend_proj``
    (frontend_dim x d_model) included; drawn like every linear
    (normal / sqrt(frontend_dim))."""
    jp, _ = _weights(arch)
    cfg = get_smoke_config(arch)
    mine = init_model(cfg, torch.Generator().manual_seed(0), device="cpu")
    want = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype))
            for k, v in jax.tree_util.tree_flatten_with_path(jp)[0]}
    got = {jax.tree_util.keystr(k): (tuple(v.shape), str(v.dtype)[6:])
           for k, v in jax.tree_util.tree_flatten_with_path(mine)[0]}
    assert got == want
    assert tuple(mine["frontend_proj"].shape) == (cfg.frontend_dim,
                                                  cfg.d_model)
    std = float(mine["frontend_proj"].std()) * cfg.frontend_dim ** 0.5
    assert 0.8 < std < 1.2


# ------------------------------------------------------------ training --
@pytest.mark.parametrize("arch", FRONTENDS)
def test_forward_loss_and_grads_match_reference(arch):
    """2 x 32: the encoder's features (bidirectional attention), the
    vlm's 8 vision positions and its ``loss_mask``; the logits, the loss
    and ``ce``, and every gradient leaf, ``frontend_proj``'s too."""
    jp, tp = _weights(arch)
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    jb, tb = _batches(arch)
    ref_logits, _ = ref_forward(jp, jcfg, jb, REF_ENGINE)
    with torch.no_grad():
        logits, _ = forward(tp, cfg, tb, DotEngine())
    np.testing.assert_allclose(logits.numpy(), np.asarray(ref_logits),
                               atol=2e-5, rtol=0)
    (ref_loss, ref_m), ref_g = jax.value_and_grad(
        lambda q: ref_loss_fn(q, jcfg, jb, REF_ENGINE), has_aux=True)(jp)
    loss, metrics, g = grads_of(cfg, tp, tb, DotEngine())
    np.testing.assert_allclose(float(loss), float(ref_loss), rtol=1e-5)
    np.testing.assert_allclose(float(metrics["ce"]), float(ref_m["ce"]),
                               rtol=1e-5)
    _leaf_errors(g, ref_g, 1e-4)
    assert float(g["frontend_proj"].abs().max()) > 0


def test_encoder_is_bidirectional():
    """Changing the last frame moves the encoder's logits at the first
    position (a causal model's would not move)."""
    _, tp = _weights(ENCODER)
    cfg = get_smoke_config(ENCODER)
    _, tb = _batches(ENCODER)
    with torch.no_grad():
        a, _ = forward(tp, cfg, tb, DotEngine())
        tb["features"][:, -1] += 1.0
        b, _ = forward(tp, cfg, tb, DotEngine())
    assert float((a[:, 0] - b[:, 0]).abs().max()) > 1e-4


def test_vlm_patches_replace_the_first_positions():
    """The vlm's logits at the vision positions do not depend on the
    tokens there, and without ``vision_embeds`` the batch is a token
    batch (the decode path's)."""
    _, tp = _weights(VLM)
    cfg = get_smoke_config(VLM)
    _, tb = _batches(VLM)
    nv = tb["vision_embeds"].shape[1]
    with torch.no_grad():
        a, _ = forward(tp, cfg, tb, DotEngine())
        tb["tokens"][:, :nv] = (tb["tokens"][:, :nv] + 1) % cfg.vocab
        b, _ = forward(tp, cfg, tb, DotEngine())
        c, _ = forward(tp, cfg, {"tokens": tb["tokens"]}, DotEngine())
    assert torch.equal(a, b)
    assert float((c[:, :nv] - b[:, :nv]).abs().max()) > 1e-4


@pytest.mark.parametrize("arch", FRONTENDS)
def test_three_train_steps_match_reference(arch):
    """Three ``make_train_step`` steps from the shared weights on
    ``make_batch`` batches: losses and gradient norms, then every
    parameter.  The encoder's ``embed`` (its vocab rows, never read:
    a zero gradient) moves by AdamW's weight decay alone, as in the
    reference."""
    jp, tp = _weights(arch)
    jcfg, cfg = jax_smoke(arch), get_smoke_config(arch)
    tp = jax.tree.map(lambda t: t.clone(), tp)
    embed0 = tp["embed"].clone()
    ocfg = dict(peak_lr=3e-3, warmup=1, total_steps=3)
    ref_step = jax.jit(ref_make_train_step(jcfg, None, RefAdamWConfig(**ocfg),
                                           engine=REF_ENGINE))
    step = make_train_step(cfg, None, AdamWConfig(**ocfg))
    jo, to = ref_init_opt_state(jp), init_opt_state(tp)
    for i in range(3):
        jb, tb = _batches(arch, seed=10 + i)
        jp, jo, jm = ref_step(jp, jo, jb)
        tp, to, m = step(tp, to, tb)
        for k in ("loss", "grad_norm", "lr"):
            np.testing.assert_allclose(float(m[k]), float(jm[k]), rtol=1e-5)
    diff = np.concatenate([np.abs(got.numpy() - np.asarray(want)).ravel()
                           for got, want in zip(tree_leaves(tp),
                                                jax.tree.leaves(jp))])
    assert float(diff.max()) <= 2 * 3 * ocfg["peak_lr"]
    assert float(np.mean(diff > 1e-4)) <= 1e-3, int((diff > 1e-4).sum())
    if arch == ENCODER:
        np.testing.assert_allclose(tp["embed"].numpy(), np.asarray(jp["embed"]),
                                   rtol=1e-6, atol=0)
        assert not torch.equal(tp["embed"], embed0)
        assert float(to["m"]["embed"].abs().max()) == 0.0


def test_encoder_embed_gradient_is_zero():
    """``grads_of`` gives the leaf the loss never reads zeros (as
    ``jax.grad`` does), not an error."""
    jp, tp = _weights(ENCODER)
    jb, tb = _batches(ENCODER)
    ref_g = jax.grad(lambda q: ref_loss_fn(q, jax_smoke(ENCODER), jb,
                                           REF_ENGINE)[0])(jp)
    _, _, g = grads_of(get_smoke_config(ENCODER), tp, tb, DotEngine())
    assert float(np.abs(np.asarray(ref_g["embed"])).max()) == 0.0
    assert g["embed"].shape == tp["embed"].shape
    assert float(g["embed"].abs().max()) == 0.0


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_step_gemm_count(arch, remat, count_gemms):
    """GEMMs through the kernel wrapper in one step's forward and
    backward: per layer the 7 projections, their dgrad and wgrad and
    w1's recomputed pre-activation (22), a "full" remat's 7 forward
    GEMMs again; the head's 3; ``frontend_proj``'s forward and wgrad
    (the features and the vision embeddings need no gradient): 22 L + 5,
    29 L + 5 under "full".  Both policies give the same loss and
    gradients bit for bit."""
    _, tp = _weights(arch)
    cfg = dataclasses.replace(get_smoke_config(arch), remat_policy=remat)
    _, tb = _batches(arch)
    loss, _, g = grads_of(cfg, tp, tb, DotEngine())
    n = LAYER_GEMMS
    want = cfg.n_layers * (3 * n + 1 + (n if remat == "full" else 0)) + 5
    assert count_gemms[0] == want
    count_gemms[0] = 0
    with torch.no_grad():
        forward(tp, cfg, tb, DotEngine())
    assert count_gemms[0] == n * cfg.n_layers + 2
    base, _, g0 = grads_of(get_smoke_config(arch), tp, tb, DotEngine())
    assert torch.equal(loss, base)
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(g),
                                                 tree_leaves(g0)))


def _chip_smoke():
    """``chip_smoke.py`` at the repository's root, loaded as a module (its
    CUDA work runs only from ``main``)."""
    import importlib.util
    from pathlib import Path

    path = Path(__file__).resolve().parents[1] / "chip_smoke.py"
    spec = importlib.util.spec_from_file_location("chip_smoke", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("remat", ["dots", "full"])
@pytest.mark.parametrize("arch", FRONTENDS)
def test_chip_smoke_counts_equal_the_ports(arch, remat, count_gemms):
    """The card script's launch arithmetic on the SMOKE configs: its
    train-step count (``train_launches_per_step``, and the launches of
    ``train_gemms``' rows with "dots") and an encode's
    (``encode_gemms``) equal the GEMMs the port makes on the CPU."""
    cs = _chip_smoke()
    _, tp = _weights(arch)
    cfg = dataclasses.replace(get_smoke_config(arch), remat_policy=remat)
    _, tb = _batches(arch)
    grads_of(cfg, tp, tb, DotEngine())
    assert count_gemms[0] == cs.train_launches_per_step(
        cfg, remat_full=remat == "full")
    if remat == "dots":
        rows = cs.train_gemms(cfg, tuple(tb["labels"].shape))
        assert sum(r[-1] for r in rows) == count_gemms[0]
    if arch == ENCODER:
        count_gemms[0] = 0
        with torch.no_grad():
            forward(tp, cfg, tb, DotEngine())
        rows = cs.encode_gemms(cfg, tb["features"].shape[0]
                               * tb["features"].shape[1])
        assert count_gemms[0] == sum(r[-1] for r in rows)


# -------------------------------------------------------------- decode --
def test_vlm_decode_matches_full_forward():
    """The reference's serving invariant: decode step by step from a
    zero contiguous state reproduces the full-sequence forward's logits
    position by position (no vision prefix: decode takes none)."""
    cfg = dataclasses.replace(get_smoke_config(VLM), remat=False)
    _, tp = _weights(VLM)
    _, tb = _batches(VLM, b=2, s=8, seed=3)
    toks = tb["tokens"]
    with torch.no_grad():
        full, _ = forward(tp, cfg, {"tokens": toks}, DotEngine())
    st = init_decode_state(cfg, 2, 8, device="cpu")
    for pos in range(8):
        logits, st = decode_step(tp, cfg, st, toks[:, pos:pos + 1], pos,
                                 DotEngine())
        np.testing.assert_allclose(logits[:, 0].numpy(),
                                   full[:, pos].numpy(), atol=2e-3,
                                   rtol=2e-3)


@pytest.mark.parametrize("vector", [False, True], ids=["scalar", "per-row"])
def test_vlm_decode_step_matches_reference(vector, count_gemms):
    """Three decode steps from a zero contiguous state (cache 32),
    positions scalar or per row (a row masked off in the last step):
    logits within 2e-5, the state within 1e-5; 7 L + 1 GEMMs a step."""
    jp, tp = _weights(VLM)
    jcfg, cfg = jax_smoke(VLM), get_smoke_config(VLM)
    st = init_decode_state(cfg, 3, 32, device="cpu")
    jst = ref_init_state(jcfg, 3, 32)
    rng = np.random.default_rng(5)
    for i in range(3):
        toks = rng.integers(2, 128, (3, 1)).astype(np.int32)
        pos = np.array([i, i + 2, i + 5], np.int32) if vector \
            else np.int32(i)
        mask = np.array([True, i < 2, True])
        count_gemms[0] = 0
        logits, st = decode_step(tp, cfg, st, torch.from_numpy(toks),
                                 torch.as_tensor(pos), DotEngine(),
                                 row_mask=torch.from_numpy(mask))
        assert count_gemms[0] == LAYER_GEMMS * cfg.n_layers + 1
        jl, jst = ref_decode_step(jp, jcfg, jst, jnp.asarray(toks),
                                  jnp.asarray(pos), REF_ENGINE,
                                  row_mask=jnp.asarray(mask))
        np.testing.assert_allclose(logits.numpy(), np.asarray(jl),
                                   atol=2e-5, rtol=0)
        for k in ("k", "v"):
            np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                       atol=1e-5, rtol=0, err_msg=k)


def test_vlm_prefill_matches_reference():
    """``prefill_kv`` of a 9-token prompt into slot 1: logits within
    2e-5, the strips within 1e-5."""
    jp, tp = _weights(VLM)
    jcfg, cfg = jax_smoke(VLM), get_smoke_config(VLM)
    prompt = _prompts((9,), seed=6)[0]
    st = init_decode_state(cfg, 2, 16, device="cpu")
    jst = ref_init_state(jcfg, 2, 16)
    logits, st = prefill_kv(tp, cfg, st, prompt, slot=1)
    jl, jst = ref_prefill_kv(jp, jcfg, jst, jnp.asarray(prompt), slot=1,
                             engine=REF_ENGINE)
    np.testing.assert_allclose(logits.numpy(), np.asarray(jl), atol=2e-5,
                               rtol=0)
    for k in ("k", "v"):
        np.testing.assert_allclose(st[k].numpy(), np.asarray(jst[k]),
                                   atol=1e-5, rtol=0)


def test_encoder_has_no_decode_step():
    """The decode state (either layout), the decode step, bulk and
    chunked prefill and the serving loop raise for the encoder, saying
    that an encoder has no decode step; the reference has none either."""
    _, tp = _weights(ENCODER)
    cfg = get_smoke_config(ENCODER)
    assert not cfg.has_decode and not jax_smoke(ENCODER).has_decode
    for layout in ("contiguous", "paged"):
        with pytest.raises(NotImplementedError, match="no decode step"):
            init_decode_state(cfg, 1, 8, layout=layout, device="cpu")
    st = init_decode_state(get_smoke_config(VLM), 1, 8, device="cpu")
    toks = torch.zeros(1, 1, dtype=torch.int32)
    with pytest.raises(NotImplementedError, match="no decode step"):
        decode_step(tp, cfg, st, toks, 0)
    with pytest.raises(NotImplementedError, match="no decode step"):
        prefill_kv(tp, cfg, st, [3, 4])
    with pytest.raises(NotImplementedError, match="no decode step"):
        prefill_kv_chunk(tp, cfg, st, torch.zeros(1, 2, dtype=torch.int64),
                         [0], [0], [2])
    with pytest.raises(NotImplementedError, match="no decode step"):
        ServeLoop(cfg, tp, ServeConfig(), device="cpu")


# ------------------------------------------------------------- serving --
@pytest.mark.parametrize("layout", ["contiguous", "paged"])
@pytest.mark.parametrize("mode", ["lockstep", "continuous"])
def test_vlm_tokens_equal_reference(mode, layout):
    """Five ragged prompts through 2 slots (pages of 4, chunks of 5):
    the reference's greedy tokens and, continuous, its prefill tokens a
    step (serving takes no vision prefix, as in the reference)."""
    jp, tp = _weights(VLM)
    sc = dict(slots=2, cache_len=64, mode=mode, layout=layout, page_size=4,
              prefill_budget=5, eos_id=-1)
    reqs = list(enumerate(_prompts((5, 3, 7, 6, 4), seed=1)))
    ref = JaxServeLoop(jax_smoke(VLM), jp, JaxServeConfig(**sc),
                       engine=REF_ENGINE)
    mine = ServeLoop(get_smoke_config(VLM), tp, ServeConfig(**sc),
                     engine=DotEngine(schedule="morton"), device="cpu")
    assert _serve(mine, reqs, 6) == _serve(ref, reqs, 6)
    if mode == "continuous":
        assert mine.prefill_tokens_per_step == ref.prefill_tokens_per_step


def test_serve_cli_refuses_the_encoder(monkeypatch):
    """The reference's ``SystemExit`` message, before any weight is
    drawn."""
    import repro_torch.launch.serve as serve_mod

    def no_init(*a, **kw):
        raise AssertionError("weights drawn")

    monkeypatch.setattr(serve_mod, "init_model", no_init)
    for argv in (["--arch", ENCODER, "--smoke", "--device", "cpu"],
                 ["--arch", "hubert-xlarge", "--device", "cpu"]):
        with pytest.raises(SystemExit) as err:
            serve_main(argv)
        name = (get_smoke_config if "--smoke" in argv else get_config)(
            ENCODER).name
        assert str(err.value) == f"{name} is encoder-only: no serving loop"


def test_serve_cli_runs_the_vlm(capsys):
    """The CLI on llava's SMOKE config on the CPU, continuous and
    paged."""
    out = serve_main(["--arch", VLM, "--smoke", "--device", "cpu",
                      "--requests", "3", "--max-new", "4", "--mode",
                      "continuous", "--layout", "paged", "--power-backend",
                      "model", "--no-obs"])
    assert sorted(out) == [0, 1, 2]
    assert all(len(t) == 8 + 4 for t in out.values())
    assert get_smoke_config(VLM).name in capsys.readouterr().out


@pytest.mark.parametrize("arch", FRONTENDS)
def test_train_cli_runs_each_frontend(arch):
    """``launch/train.py`` on the SMOKE config on the CPU: 3 steps of 4 x
    32 (the encoder's frames, the vlm's 8 patches and loss mask from
    ``PackedSyntheticData``), a finite last loss and every parameter
    finite."""
    from repro_torch.launch.train import main as train_main

    out = train_main(["--arch", arch, "--smoke", "--device", "cpu",
                      "--steps", "3", "--batch", "4", "--seq", "32",
                      "--log-every", "1", "--power-backend", "model",
                      "--no-obs"])
    assert np.isfinite(out["last_loss"])
    assert all(bool(torch.isfinite(t).all())
               for t in tree_leaves(out["params"]))


# ---------------------------------------------------------- layer_norm --
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_layer_norm_matches_reference(dtype):
    """(4, 7, 96) inputs of mean 3 and scale 2, random gamma and beta:
    within 1e-6 in f32 and one bf16 rounding step in bf16."""
    rng = np.random.default_rng(11)
    x = (3 + 2 * rng.standard_normal((4, 7, 96))).astype(np.float32)
    gamma = rng.standard_normal(96).astype(np.float32)
    beta = rng.standard_normal(96).astype(np.float32)
    jdt, tdt = jnp.dtype(dtype), getattr(torch, dtype)
    want = np.asarray(ref_layer_norm(jnp.asarray(x, jdt),
                                     jnp.asarray(gamma, jdt),
                                     jnp.asarray(beta, jdt)), np.float32)
    got = layer_norm(torch.from_numpy(x).to(tdt),
                     torch.from_numpy(gamma).to(tdt),
                     torch.from_numpy(beta).to(tdt))
    assert got.dtype == tdt
    tol = (1e-6, 0) if dtype == "float32" else (1e-2, 2.0 ** -7)
    np.testing.assert_allclose(got.float().numpy(), want, atol=tol[0],
                               rtol=tol[1])
