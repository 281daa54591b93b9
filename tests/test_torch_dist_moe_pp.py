"""Expert parallelism and the GPipe pipeline of the port against the
reference's own *sharded* functions.

The reference's ``moe_ep`` (``shard_map`` with two ``all_to_all``\\ s)
and ``pipeline_apply`` (``ppermute`` hand-offs, a ``psum`` broadcast)
run here: a subprocess with ``XLA_FLAGS=--xla_force_host_platform_
device_count=8`` computes them as the reference selftest does
(``src/repro/launch/selftest.py:102-131`` and ``:289-318``) and writes
inputs and outputs to ``tmp_path`` as ``.npy`` files, as
``tests/test_distributed.py`` runs its checks.  The port's counterparts
run on gloo ranks (``repro_torch.distributed.ctx.spawn``): ``moe_ep`` on
a (2, 2) ("data", "model") mesh of 4 ranks, granite-moe-1b SMOKE with
its 8 experts over the model axis; ``pipeline_apply`` on the pod axis
of a (2, 2, 2) mesh of 8.

Bounds: ``moe_ep`` within 1e-5 (f32; the expert GEMMs run through the
port's ``DotEngine``, the reference's through XLA einsums), at the
selftest's capacity factor 8 (no drops) and at the default 1.25 (each
shard drops the same assignments); ``pipeline_apply`` within 1e-6.
"""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
torch = pytest.importorskip("torch")

import _dist_ranks
from repro_torch.distributed.ctx import spawn

ROOT = Path(__file__).resolve().parents[1]
MOE_ARCH = "granite_moe_1b_a400m"
FACTORS = (8.0, 1.25)

REFERENCE = r'''
import sys
import numpy as np
import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.configs import get_smoke_config
from repro.launch.mesh import make_smoke_mesh
from repro.launch.pp import pipeline_apply
from repro.models.layers import DotEngine
from repro.models.moe import init_moe, moe_ep

out = sys.argv[1]
mesh = make_smoke_mesh((2, 2), ("data", "model"))
cfg = get_smoke_config("granite_moe_1b_a400m")
params = init_moe(jax.random.PRNGKey(0), cfg, model_axis_size=2)
x = jax.random.normal(jax.random.PRNGKey(1), (4, 8, cfg.d_model))
xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
ps = jax.device_put(params, {
    "router": NamedSharding(mesh, P()),
    "w1": NamedSharding(mesh, P("model", None, None)),
    "w3": NamedSharding(mesh, P("model", None, None)),
    "w2": NamedSharding(mesh, P("model", None, None))})
for k, v in params.items():
    np.save(f"{out}/moe_{k}.npy", np.asarray(v))
np.save(f"{out}/moe_x.npy", np.asarray(x))
for cf in (8.0, 1.25):
    y, aux = jax.jit(lambda x, p: moe_ep(x, p, cfg, mesh, DotEngine(),
                                         capacity_factor=cf,
                                         data_axes=("data",)))(xs, ps)
    np.save(f"{out}/moe_y_{cf}.npy", np.asarray(y))
    np.save(f"{out}/moe_aux_{cf}.npy", np.asarray(aux))

mesh = make_smoke_mesh((2, 2, 2))
L, d, m, mb = 4, 16, 3, 8
w = jax.random.normal(jax.random.PRNGKey(0), (L, d, d)) * (0.5 / np.sqrt(d))
x = jax.random.normal(jax.random.PRNGKey(1), (m, mb, d))

def stage_fn(stage_w, xin):
    def body(h, wl):
        return jnp.tanh(h @ wl), None
    out, _ = jax.lax.scan(body, xin, stage_w)
    return out

y = jax.jit(lambda w, x: pipeline_apply(stage_fn, w, x, mesh,
                                        axis="pod"))(w, x)
np.save(f"{out}/pp_w.npy", np.asarray(w))
np.save(f"{out}/pp_x.npy", np.asarray(x))
np.save(f"{out}/pp_y.npy", np.asarray(y))
print("OK reference")
'''


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    out = tmp_path_factory.mktemp("ref_sharded")
    env = dict(os.environ, JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8",
               PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", REFERENCE, str(out)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert r.returncode == 0 and "OK reference" in r.stdout, r.stderr[-3000:]
    return {p.stem: np.load(p) for p in out.glob("*.npy")}


@pytest.mark.parametrize("capacity_factor", FACTORS)
def test_moe_ep_equals_reference_moe_ep(reference, capacity_factor):
    params = {k: reference[f"moe_{k}"] for k in ("router", "w1", "w3", "w2")}
    assert params["w1"].shape[0] == 8       # 8 experts, 4 a rank
    got = spawn(_dist_ranks.moe_ep_ranks, 4, MOE_ARCH, params,
                reference["moe_x"], capacity_factor)
    want = reference[f"moe_y_{capacity_factor}"]
    assert got["y"].shape == want.shape == (4, 8, 64)
    np.testing.assert_allclose(got["y"], want, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(got["aux"],
                               float(reference[f"moe_aux_{capacity_factor}"]),
                               rtol=1e-5)
    # the buckets travel by exactly two all-to-alls
    assert got["collectives"]["all_to_all"] == 2


def test_pipeline_apply_equals_reference_pipeline(reference):
    got = spawn(_dist_ranks.pipeline_ranks, 8, reference["pp_w"],
                reference["pp_x"])
    np.testing.assert_allclose(got["y"], reference["pp_y"], rtol=1e-6,
                               atol=1e-6)
    # M + S - 1 = 4 ticks, one hand-off each
    assert got["sends"] == 4
