"""Port parity of the sharded forward and serving on a 4-rank gloo world
(CPU): ``repro_torch.dist`` with explicit collectives around each rank's
local shards, against the port's unsharded path and the reference's
expert-parallel ``moe_apply(ctx)``.

One world of 4 spawned ranks (``tests/_torch_world.py``; a ``(data 2, model
2)`` mesh, and a ``(pod 2, data 1, model 2)`` one for a two-axis dp group)
runs every case and pickles its results; each test below reads its part.
Before it, one JAX child on 4 forced host devices writes the reference's
``moe_apply(ctx)`` on a ``(2, 2)`` mesh (as ``tests/test_distribution.py``
runs the reference).

* the sharded forward of the six families' smoke configs (f32): bit-equal
  to the unsharded forward where only quantized leaves and the embedding
  are sharded (``lut`` on gemma2-2b, whose head is tied), else within 1e-5 x
  max |logit|; the uncalibrated ``lut`` cases hold only with the dp-global
  activation abs-max, asserted on its own too;
* EP ``moe_apply`` within 1e-6 x max |y| of the reference's, and at tp 2
  bit-equal to the port's unsharded ``moe_apply`` (the reference's EP
  equals its own unsharded output bit for bit; the two packages' expert
  GEMMs differ in the last bits);
* ``pipeline_apply`` at 4 stages bit-equal to the stages applied in turn,
  and ``compressed_psum`` over 4 ranks bit-equal to the reference's under
  ``jax.vmap``;
* ``ServeEngine(ctx=)`` under the scan, loop and chunked drivers: tokens,
  admissions and bucket counts equal to the unsharded engine's, one host
  sync a wave on every rank;
* what a mesh still refuses: training, and ``seq_shard`` execution.
"""

import os
import pickle
import subprocess
import sys
import textwrap

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

import _torch_world as world  # noqa: E402
from repro.dist.collectives import compressed_psum as jcompressed_psum  # noqa: E402

TOL_FORWARD = 1e-5            # sharded vs unsharded logits, relative to max |logit|
TOL_EP = 1e-6                 # EP moe_apply vs the reference's, relative to max |y|
TOL_AUX = 1e-6                # the MoE aux loss: a global mean summed in another order
TIMEOUT_S = 300

REF_EP = """
import pickle, sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import NamedSharding, PartitionSpec as P
from repro.dist import sharding as shd
from repro.launch.mesh import make_smoke_mesh
from repro.models import moe
from repro.models.config import ModelConfig, MoEConfig

spec = dict(n_experts=4, n_shared_experts=1, top_k=2, d_ff_expert=8, capacity_factor=8.0)
cfg = ModelConfig(name="m", family="moe", n_layers=1, d_model=16, n_heads=2, n_kv_heads=2,
                  d_ff=32, vocab_size=64, moe=MoEConfig(**spec))
p = moe.moe_init(cfg, jax.random.PRNGKey(0))
x = jax.random.normal(jax.random.PRNGKey(1), (4, 6, 16), jnp.float32)
mesh = make_smoke_mesh(4)      # data=2, model=2: EP over 2 shards
ctx = shd.ShardCtx(mesh=mesh, dp_axes=("data",), tp_axis="model")
xs = jax.device_put(x, NamedSharding(mesh, P("data", None, None)))
ps = jax.device_put(p, jax.tree.map(
    lambda a: NamedSharding(mesh, P("model", None, None)) if a.ndim == 3
    else NamedSharding(mesh, P()), p))
y, aux = jax.jit(lambda p_, x_: moe.moe_apply(p_, x_, cfg, ctx))(ps, xs)
with open(sys.argv[1], "wb") as f:
    pickle.dump({"moe": spec, "params": jax.tree.map(np.asarray, p), "x": np.asarray(x),
                 "y": np.asarray(y), "aux": float(aux)}, f)
"""


@pytest.fixture(scope="module")
def ranks(tmp_path_factory):
    """Every rank's results: the reference child first, then the world."""
    import multiprocessing as mp

    out = tmp_path_factory.mktemp("world")
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.path.join(os.path.dirname(__file__), "..", "src")}
    res = subprocess.run([sys.executable, "-c", textwrap.dedent(REF_EP), str(out / "ref_ep.pkl")],
                         env=env, capture_output=True, text=True, timeout=TIMEOUT_S)
    assert res.returncode == 0, res.stderr
    spawn = mp.get_context("spawn")
    procs = [spawn.Process(target=world.rank_main, args=(r, str(out))) for r in range(world.WORLD)]
    for p in procs:
        p.start()
    try:
        for p in procs:
            p.join(TIMEOUT_S)
    finally:
        hung = [p for p in procs if p.is_alive()]
        for p in hung:
            p.terminate()
            p.join(10)
    results = []
    for r in range(world.WORLD):
        path = out / f"rank{r}.pkl"
        results.append(pickle.loads(path.read_bytes()) if path.exists() else
                       {"error": f"rank {r} wrote nothing (exit {procs[r].exitcode})"})
    errors = [res.get("error") for res in results if res.get("error")]
    assert not hung and not errors, (len(hung), errors)
    return results


@pytest.mark.parametrize("case", sorted(world.FORWARD_CASES))
def test_sharded_forward_equals_unsharded(ranks, case):
    for r, res in enumerate(ranks):
        f = res["forward"][case]
        assert f["shape"][0] == 2, f
        if f["exact"]:
            assert f["equal"], (r, f)
        assert f["err"] <= TOL_FORWARD, (r, f)
        assert f["aux_err"] <= TOL_AUX, (r, f)


def test_uncalibrated_lut_scale_is_global_over_dp(ranks):
    for res in ranks:
        assert res["global_amax"]["global_equal"]
    # dp rank 0's rows hold the batch's max: the other dp rank's own rows
    # would give another scale (so the all-reduce is what the test sees).
    assert any(res["global_amax"]["local_differs"] for res in ranks)


def test_expert_parallel_moe_equals_reference(ranks):
    for res in ranks:
        ep = res["ep"]
        assert ep["local_experts"] == 2
        assert ep["err"] <= TOL_EP, ep
        # At tp 2 each token's expert outputs are summed as unsharded (a sum
        # of two partials): bit-equal to the port's unsharded moe_apply, as
        # the reference's EP equals its own.  Against the reference the
        # expert GEMMs (torch.bmm vs XLA's dot) differ in the last bits.
        assert ep["equal_unsharded"], ep
        assert ep["aux_err"] <= TOL_AUX, ep


def test_pipeline_apply_four_stages_equals_sequential(ranks):
    for res in ranks:
        assert res["pipeline"]["equal"] and res["pipeline"]["shape"] == (6, 2, 8)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
def test_compressed_psum_over_four_ranks_equals_reference(ranks, dtype):
    xs = ranks[0]["psum"]["inputs"]
    jx = jnp.asarray(xs).astype(jnp.float32 if dtype == "f32" else jnp.bfloat16)
    want = np.asarray(jax.vmap(lambda v: jcompressed_psum(v, "i"), axis_name="i")(jx)
                      .astype(jnp.float32))
    for r, res in enumerate(ranks):
        np.testing.assert_array_equal(res["psum"][dtype].view(np.uint32),
                                      want[r].view(np.uint32))


@pytest.mark.parametrize("driver", world.SERVE_DRIVERS)
def test_sharded_serve_equals_unsharded(ranks, driver):
    for res in ranks:
        s = res["serve"][driver]
        ref, got = s["ref"], s["sharded"]
        assert got["tokens"] == ref["tokens"]
        assert got["admissions"] == ref["admissions"]
        assert got["buckets"] == ref["buckets"]
        assert got["host_syncs"] == ref["host_syncs"]
        if driver == "scan":
            assert got["host_syncs"] == got["waves"] > 1


def test_mesh_refuses_only_training_and_seq_shard(ranks):
    for res in ranks:
        msgs = res["refusals"]
        assert "Sharded training" in msgs["train_step"]
        assert "seq_shard execution" in msgs["seq_shard"]
