"""Port parity for the tuner: ``repro_torch.tune`` against ``repro.tune``
under the reference's own constants (``TPU_V5E``, read from ``repro``
here and nowhere in the port).

``predict``, ``predict_attn``, ``with_f_scale``, ``estimate_energy`` and
``objective_value`` give equal numbers (1e-12 relative: the same float
arithmetic over the same LRU replay); ``candidate_configs`` are equal
lists; analytic ``autotune``/``resolve`` winners are equal for each
objective, with and without an epilogue and a ``CommSpec``; cache keys
are equal and each package reads a cache file the other wrote.  Under
the port's ``H100`` preset, every candidate is a launch the port's SFC
kernel takes, and no two candidates are the same launch."""
import dataclasses

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import repro.core.energy as ref_energy
import repro.tune as ref_tune
import repro_torch.tune as port_tune
from repro_torch.analysis.contracts import check_gemm_contract, \
    gemm_launch_key
from repro_torch.core.energy import H100, HW

REF_HW = HW(**dataclasses.asdict(ref_energy.TPU_V5E))

# (m, n, k, dtype_bytes, capacity): serving-like, square, ragged, and a
# small cache that reaches the memory-bound regime
SHAPES = [(8, 512, 256, 2, None), (256, 256, 256, 4, None),
          (300, 200, 520, 4, None), (512, 512, 256, 4, 4)]
EPILOGUES = [None, dict(bias=True, activation="gelu"), dict(residual=True)]
COMMS = [None, dict(ways=4, hops=1.5)]


def _rel(a, b, tol=1e-12):
    return abs(a - b) <= tol * max(abs(a), abs(b))


def _ep(pkg, spec):
    return None if spec is None else pkg.EpilogueSpec(**spec)


def _comm(pkg, spec):
    return None if spec is None else pkg.CommSpec(**spec)


def _same_estimate(a, b):
    assert dataclasses.asdict(a.config) == dataclasses.asdict(b.config)
    for name in ("time", "traffic_bytes", "t_compute", "t_hbm", "t_index",
                 "flops", "ici_bytes", "t_ici"):
        assert _rel(getattr(a, name), getattr(b, name)), name
    assert set(a.extras) == set(b.extras)
    for key, va in a.extras.items():
        vb = b.extras[key]
        if isinstance(va, float):
            assert _rel(va, vb), key
        else:
            assert va == vb, key


def _cfgs(pkg):
    return [pkg.TuneConfig("xla"), pkg.TuneConfig("rowmajor"),
            pkg.TuneConfig("morton", 128, 128, 256, False),
            pkg.TuneConfig("hilbert", 256, 256, 128, True, 0, 0.75),
            pkg.TuneConfig("supertile", 128, 128, 128, True, 2, 1.25),
            pkg.TuneConfig("boustrophedon", 64, 128, 128)]


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("ep", EPILOGUES)
@pytest.mark.parametrize("comm", COMMS)
def test_predict_energy_objectives_equal(shape, ep, comm):
    m, n, k, db, cap = shape
    for c_port, c_ref in zip(_cfgs(port_tune), _cfgs(ref_tune)):
        a = port_tune.predict(c_port, m, n, k, db, hw=REF_HW,
                              capacity=cap, epilogue=_ep(port_tune, ep),
                              comm=_comm(port_tune, comm))
        b = ref_tune.predict(c_ref, m, n, k, db, hw=ref_energy.TPU_V5E,
                             capacity=cap, epilogue=_ep(ref_tune, ep),
                             comm=_comm(ref_tune, comm))
        _same_estimate(a, b)
        for f in (0.5, 0.9, 1.25):
            _same_estimate(port_tune.with_f_scale(a, f, hw=REF_HW),
                           ref_tune.with_f_scale(b, f,
                                                 hw=ref_energy.TPU_V5E))
        for wall in (None, 3e-4):
            ea = port_tune.estimate_energy(a, hw=REF_HW, wall_time=wall)
            eb = ref_tune.estimate_energy(b, hw=ref_energy.TPU_V5E,
                                          wall_time=wall)
            for key in ("time", "core", "hbm", "ici", "static", "total"):
                assert _rel(ea[key], eb[key]), key
            for obj in port_tune.OBJECTIVES:
                assert _rel(
                    port_tune.objective_value(a, obj, hw=REF_HW,
                                              wall_time=wall),
                    ref_tune.objective_value(b, obj, hw=ref_energy.TPU_V5E,
                                             wall_time=wall))
    assert port_tune.OBJECTIVES == ref_tune.OBJECTIVES


@pytest.mark.parametrize("kind,ps,share", [("contig", 0, 1.0),
                                           ("paged", 8, 1.0),
                                           ("paged", 16, 0.62)])
@pytest.mark.parametrize("comm", COMMS)
def test_predict_attn_equal(kind, ps, share, comm):
    lengths = [0, 5, 33, 64]
    for f in (0.5, 1.0, 1.25):
        a = port_tune.predict_attn(
            port_tune.TuneConfig("x", f_scale=f),
            port_tune.AttnSpec(kind, ps, share), slots=4, cache_len=64,
            n_heads=16, n_kv_heads=8, d_head=128, lengths=lengths,
            dtype_bytes=2, hw=REF_HW, comm=_comm(port_tune, comm))
        b = ref_tune.predict_attn(
            ref_tune.TuneConfig("x", f_scale=f),
            ref_tune.AttnSpec(kind, ps, share), slots=4, cache_len=64,
            n_heads=16, n_kv_heads=8, d_head=128, lengths=lengths,
            dtype_bytes=2, hw=ref_energy.TPU_V5E, comm=_comm(ref_tune, comm))
        _same_estimate(a, b)


@pytest.mark.parametrize("shape", SHAPES + [(4096, 4096, 4096, 4, None),
                                            (4, 151936, 2048, 2, None)])
@pytest.mark.parametrize("ep", EPILOGUES)
def test_candidate_configs_equal(shape, ep):
    m, n, k, db, _ = shape
    a = port_tune.candidate_configs(m, n, k, dtype_bytes=db, hw=REF_HW,
                                    epilogue=_ep(port_tune, ep))
    b = ref_tune.candidate_configs(m, n, k, dtype_bytes=db,
                                   hw=ref_energy.TPU_V5E,
                                   epilogue=_ep(ref_tune, ep))
    assert [c.to_dict() for c in a] == [c.to_dict() for c in b]
    assert port_tune.vmem_block_capacity(128, 256, 128, db, hw=REF_HW) == \
        ref_tune.vmem_block_capacity(128, 256, 128, db,
                                     hw=ref_energy.TPU_V5E)


@pytest.mark.parametrize("objective", ["time", "energy", "edp"])
@pytest.mark.parametrize("ep", EPILOGUES)
@pytest.mark.parametrize("comm", COMMS)
def test_analytic_winners_equal(tmp_path, objective, ep, comm):
    """autotune and resolve(search=True), analytic (measure=False), at a
    memory-bound shape with a small cache and at a serving shape."""
    for i, (m, n, k, db, cap) in enumerate([(512, 512, 256, 4, 4),
                                            (8, 512, 256, 2, None)]):
        dt = "float32" if db == 4 else "bfloat16"
        kw = dict(backend="cpu", objective=objective, refresh=True,
                  measure=False, capacity=cap)
        a = port_tune.autotune(
            m, n, k, dt, hw=REF_HW, epilogue=_ep(port_tune, ep),
            comm=_comm(port_tune, comm),
            cache=port_tune.TuneCache(str(tmp_path / f"p{i}.json")), **kw)
        b = ref_tune.autotune(
            m, n, k, dt, hw=ref_energy.TPU_V5E, epilogue=_ep(ref_tune, ep),
            comm=_comm(ref_tune, comm),
            cache=ref_tune.TuneCache(str(tmp_path / f"r{i}.json")), **kw)
        assert a.key == b.key
        assert a.config.to_dict() == b.config.to_dict()
        assert [e.config.to_dict() for e in a.estimates] == \
            [e.config.to_dict() for e in b.estimates]
        ra = port_tune.resolve(
            port_tune.GemmSpec(m, n, k, dt, epilogue=_ep(port_tune, ep),
                               comm=_comm(port_tune, comm)),
            search=True, hw=REF_HW,
            cache=port_tune.TuneCache(str(tmp_path / f"pr{i}.json")), **kw)
        rb = ref_tune.resolve(
            ref_tune.GemmSpec(m, n, k, dt, epilogue=_ep(ref_tune, ep),
                              comm=_comm(ref_tune, comm)),
            search=True, hw=ref_energy.TPU_V5E,
            cache=ref_tune.TuneCache(str(tmp_path / f"rr{i}.json")), **kw)
        assert ra.config.to_dict() == rb.config.to_dict() == \
            a.config.to_dict()


@pytest.mark.parametrize("objective", ["time", "energy", "edp"])
@pytest.mark.parametrize("share", [1.0, 0.5])
def test_attention_winners_equal(tmp_path, objective, share):
    kw = dict(n_heads=16, n_kv_heads=8, d_head=128, dtype="bfloat16",
              backend="cpu", objective=objective, lengths=[16, 40, 64, 0])
    a = port_tune.autotune_attn(
        4, 64, attn=port_tune.AttnSpec("paged", 16, share), hw=REF_HW,
        cache=port_tune.TuneCache(str(tmp_path / "p.json")), **kw)
    b = ref_tune.autotune_attn(
        4, 64, attn=ref_tune.AttnSpec("paged", 16, share),
        hw=ref_energy.TPU_V5E,
        cache=ref_tune.TuneCache(str(tmp_path / "r.json")), **kw)
    assert a.key == b.key
    assert a.config.to_dict() == b.config.to_dict()


@pytest.mark.parametrize("args,kw", [
    ((4, 2048, 2048, "bfloat16", "cpu"), {}),
    ((16, 2048, 2048, "bfloat16", "cuda"), dict(objective="edp")),
    ((128, 6144, 2048, "bfloat16", "cuda"),
     dict(epilogue="silu", batched=True)),
    ((4, 1024, 64, "float32", "cpu"),
     dict(attn="paged-p16-s0.50", objective="energy")),
    ((300, 200, 520, "float32", "cpu"), dict(comm="tp4-h1.50")),
])
def test_cache_keys_equal(args, kw):
    assert port_tune.cache_key(*args, **kw) == ref_tune.cache_key(*args, **kw)
    assert port_tune.shape_bucket(*args[:3]) == ref_tune.shape_bucket(*args[:3])


def test_each_package_reads_the_others_cache(tmp_path):
    """A winner one package persisted is a cache hit for the other, with
    the same config."""
    pa, pb = str(tmp_path / "from_port.json"), str(tmp_path / "from_ref.json")
    kw = dict(backend="cpu", objective="edp", measure=False)
    port_won = port_tune.autotune(256, 256, 256, "float32", hw=REF_HW,
                                  cache=port_tune.TuneCache(pa), **kw)
    ref_won = ref_tune.autotune(300, 200, 520, "float32",
                                hw=ref_energy.TPU_V5E,
                                cache=ref_tune.TuneCache(pb),
                                epilogue=ref_tune.EpilogueSpec(residual=True),
                                **kw)
    hit = ref_tune.autotune(256, 256, 256, "float32",
                            cache=ref_tune.TuneCache(pa), **kw)
    assert hit.from_cache and hit.config.to_dict() == port_won.config.to_dict()
    hit = port_tune.autotune(300, 200, 520, "float32",
                             cache=port_tune.TuneCache(pb),
                             epilogue=port_tune.EpilogueSpec(residual=True),
                             **kw)
    assert hit.from_cache and hit.config.to_dict() == ref_won.config.to_dict()
    assert set(port_tune.TuneCache(pb).keys()) == \
        set(ref_tune.TuneCache(pb).keys())


@pytest.mark.parametrize("m,n,k,dt", [
    (4, 2048, 2048, "bfloat16"), (4, 6144, 2048, "bfloat16"),
    (4, 2048, 6144, "bfloat16"), (4, 151936, 2048, "bfloat16"),
    (128, 2048, 2048, "bfloat16"), (128, 6144, 2048, "bfloat16"),
    (1024, 1024, 1024, "float32"), (4096, 4096, 4096, "float32"),
    (300, 200, 520, "float32")])
@pytest.mark.parametrize("ep", EPILOGUES)
def test_h100_candidates_are_distinct_port_kernel_launches(m, n, k, dt, ep):
    """Under H100 every kernel candidate has bm and bn multiples of 16 up
    to 128 and A + B tiles within one block's shared memory (the port
    wrapper's rule, ``kernels/sfc_matmul.py``), passes the contract's
    full level, and no two candidates are the same launch; the library
    baseline is kept."""
    db = 2 if dt == "bfloat16" else 4
    cands = port_tune.candidate_configs(m, n, k, dtype_bytes=db,
                                        epilogue=_ep(port_tune, ep))
    assert cands[0].schedule == "xla"
    keys = set()
    for c in cands[1:]:
        assert c.bm % 16 == 0 and c.bn % 16 == 0
        assert 0 < c.bm <= 128 and 0 < c.bn <= 128
        assert (c.bm * c.bk + c.bk * c.bn) * db <= H100.vmem_per_chip
        assert check_gemm_contract(c, m, n, k, dtype_bytes=db, hw=H100,
                                   level="full").ok
        keys.add(gemm_launch_key(c, m, n, k, db))
    assert len(keys) == len(cands) - 1
    if m <= 8:   # the rows path: bm and bk never reach the kernel
        assert all(c.bn != 128 or c.bm == cands[1].bm for c in cands[1:])


def test_h100_rejects_what_the_port_kernel_refuses():
    cfg = port_tune.TuneConfig("morton", 256, 256, 128)
    codes = check_gemm_contract(cfg, 1024, 1024, 1024, hw=H100,
                                level="fast").codes()
    assert codes == {"kernel-tile", "vmem-budget"}
    assert check_gemm_contract(cfg, 1024, 1024, 1024, hw=REF_HW,
                               level="fast").ok
    # a cached winner past shared memory gets the reference's repair,
    # 128^3 blocks; one that fits but has tiles the kernel cannot take is
    # not repaired (only a cache the port did not write holds one)
    from repro_torch.tune.autotune import _validate_for_shape
    fixed = _validate_for_shape(dataclasses.replace(cfg, f_scale=0.75),
                                1024, 1024, 1024)
    assert (fixed.bm, fixed.bn, fixed.bk, fixed.f_scale) == \
        (128, 128, 128, 0.75)
    odd = port_tune.TuneConfig("morton", 256, 128, 16)
    assert check_gemm_contract(odd, 1024, 1024, 1024, hw=H100,
                               level="fast").codes() == {"kernel-tile"}
    assert _validate_for_shape(odd, 1024, 1024, 1024) == odd


def test_cuda_keyspace_buckets_the_rows_path_apart(tmp_path, monkeypatch):
    """On "cuda" a decode GEMM (M <= 8, the kernel's rows path) and a
    chunk GEMM (M = 128, the tile path) resolve to different cache
    entries: a winner persisted for the chunk shape is never served to
    a decode GEMM of the same N and K, which gets a search of its own.
    Every M in 1..8 shares the rows bucket; the "cpu" keyspace keeps the
    reference's buckets."""
    monkeypatch.setenv("REPRO_TUNE_MEASURE", "0")
    cache = port_tune.TuneCache(str(tmp_path / "t.json"))
    chunk_key = port_tune.cache_key(128, 2048, 2048, "bfloat16", "cuda")
    seeded = port_tune.TuneConfig("hilbert", 64, 112, 16, True, 0, 0.75)
    cache.put(chunk_key, {"config": seeded.to_dict()})
    chunk = port_tune.resolve_config(128, 2048, 2048, torch.bfloat16,
                                     backend="cuda", cache=cache)
    decode = port_tune.resolve_config(4, 2048, 2048, torch.bfloat16,
                                      backend="cuda", cache=cache)
    assert chunk == seeded and decode != seeded
    decode_key = port_tune.cache_key(4, 2048, 2048, "bfloat16", "cuda")
    assert decode_key != chunk_key and set(cache.keys()) == \
        {chunk_key, decode_key}
    assert port_tune.TuneCache(cache.path).get(decode_key)["shape"] == \
        [4, 2048, 2048]
    keys = {port_tune.cache_key(m, 2048, 2048, "bfloat16", "cuda")
            for m in range(1, 9)}
    assert keys == {"mm/8x2048x2048/bfloat16/cuda"}
    assert port_tune.cache_key(4, 2048, 2048, "bfloat16", "cuda",
                               batched=True) == \
        "bmm/8x2048x2048/bfloat16/cuda"
    assert port_tune.cache_key(9, 2048, 2048, "bfloat16", "cuda") == \
        chunk_key
    assert port_tune.cache_key(4, 2048, 2048, "bfloat16", "cpu") == \
        ref_tune.cache_key(4, 2048, 2048, "bfloat16", "cpu") == \
        "mm/128x2048x2048/bfloat16/cpu"


def test_default_cache_file_is_the_ports_own(monkeypatch, tmp_path):
    """Without REPRO_TUNE_CACHE the port's cache file is not the
    reference's; with it, both packages name the same file."""
    monkeypatch.delenv("REPRO_TUNE_CACHE", raising=False)
    monkeypatch.setenv("XDG_CACHE_HOME", str(tmp_path))
    assert port_tune.default_cache_path() != ref_tune.default_cache_path()
    assert port_tune.default_cache_path().startswith(str(tmp_path))
    monkeypatch.setenv("REPRO_TUNE_CACHE", str(tmp_path / "shared.json"))
    assert port_tune.default_cache_path() == ref_tune.default_cache_path()


def test_h100_analytic_search_on_the_cpu(tmp_path):
    """On the CPU the port scores analytically (no measurement) under
    H100, every objective: a winner and a cache entry keyed "cpu"."""
    cache = port_tune.TuneCache(str(tmp_path / "t.json"))
    for obj in port_tune.OBJECTIVES:
        r = port_tune.autotune(128, 2048, 2048, torch.bfloat16, cache=cache,
                               objective=obj, backend="cpu")
        assert not r.measured and r.key.startswith("mm/128x2048x2048/"
                                                   "bfloat16/cpu")
        assert np.isfinite(r.best_estimate.time)
    assert len(cache) == 3
