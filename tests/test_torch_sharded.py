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
* ``ServeEngine(plan=, ctx=)`` on (1, 4) and (2, 2) under the scan and
  chunked drivers: each rank prepares its raw shard of the reference's
  calibrated stablelm-12b smoke tree (W1A3 ``lut``, f32) under the global
  analytic plan and serves the reference's unsharded planned tokens,
  admissions and host syncs (the JAX child serves them); a plan made on a
  shard is refused on every rank, and so is a mismatch or a failed check on
  one rank alone; each rank's prepared bytes are the plan's
  for its shards;
* ``seq_shard``: the caches of seven cache branches (full, int8, ring,
  MLA, zamba2's shared block, whisper's cross caches, rwkv6's feature-sharded
  token-shift rows) cut along dim 2 on (1, 4) and (2, 2): prefill and decode
  logits against the unsharded port and the reference's jitted steps (the
  JAX child computes those while the world runs), and ``ServeEngine(ctx=)``
  on the three drivers against the unsharded engine; cache-free steps under
  ``seq_shard`` equal those without it.
"""

import dataclasses
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
TOL_STEP = 1e-6               # loss and grad_norm of the sharded step, relative
TOL_PARAM = 5e-2              # parameters after one AdamW step: the reference's bound
                              # (tests/test_distribution.py:158; a near-zero gradient whose
                              # sign flips moves a parameter by 2 lr)
TOL_REF_LOSS = 2e-2           # the sharded step vs the reference's local step: its own
TOL_REF_GRAD = 1e-4           # bounds, and the cross-package gradient bound
                              # (tests/test_torch_train.py)
TOL_LAUNCH = 1e-5             # the sharded launcher's losses vs the unsharded launcher's
TOL_SEQ = 1e-4                # sequence-sharded logits vs unsharded / the reference's,
                              # relative to max |logit| (the reference's f32 bound)
TOL_SEQ_INT8 = 1e-3           # ... the int8 cache against the reference: a K / V value whose
                              # f32 bits differ between the packages may round to the next
                              # code (tests/test_torch_model.py's TOL_INT8; the port's own
                              # unsharded int8 logits sit 1.2e-4 .. 2.3e-4 from the
                              # reference's GSPMD steps on (1, 4))
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

# The reference's chatglm3-6b smoke step (f32, its test's batch), jitted:
# make_train_step's body (accum_steps=1) with its gradient returned.  The
# stepped state is saved under its (2, 2) FSDP + TP shardings.
import dataclasses
from repro.ckpt import checkpoint as jck
from repro.configs import get_config
from repro.models.model import build_model
from repro.train import optimizer as jopt, train_step as jts

tcfg = dataclasses.replace(get_config("chatglm3-6b", smoke=True), dtype="float32")
tm = build_model(tcfg)
state = jts.init_train_state(tm, jax.random.PRNGKey(0))
tokens = np.random.default_rng(0).integers(0, tcfg.vocab_size, (4, 13)).astype(np.int32)
loss_fn = jts.make_loss_fn(tm, remat=True)
ocfg = jopt.AdamWConfig(lr=1e-3)

@jax.jit
def step(state, batch):
    (loss, _), g = jax.value_and_grad(loss_fn, has_aux=True)(state.params, batch)
    p_new, o_new, _m = jopt.apply_updates(state.params, g, state.opt, ocfg)
    return loss, g, jts.TrainState(params=p_new, opt=o_new, step=state.step + 1)

loss, grads, new = step(state, {"tokens": jnp.asarray(tokens)})
tctx = shd.ShardCtx(mesh=mesh, dp_axes=("data",), tp_axis="model", fsdp=True)
pspec = shd.param_specs(tcfg, new.params, tctx)
sspec = jts.TrainState(params=pspec, opt={"mu": pspec, "nu": pspec, "step": P()}, step=P())
jck.save(sys.argv[2], 5, jax.device_put(new, shd.to_shardings(sspec, mesh)))
as_np = lambda st: {"params": jax.tree.map(np.asarray, st.params),
                    "opt": jax.tree.map(np.asarray, st.opt), "step": np.asarray(st.step)}

# The reference launcher's stablelm-12b smoke tree, W1A3 lut, f32, its scales
# calibrated by the reference, carried into the port with its walk order
# kept, and the port's analytic plan of it: the world's ranks serve this tree
# sharded under that plan (ref_plan_tree.pkl); the reference serves it
# unsharded at the end (ref_plan.pkl).
import os
import _torch_world as world
from repro.core import LutLinearSpec as JSpec
from repro.core.calibrate import calibrate_tree as jcalibrate
from repro_torch.convert import params_from_numpy
from repro_torch.tune import plan_model

pcfg = world._cfg("stablelm-12b", get_config)
pm = build_model(pcfg)
ptoks = jnp.asarray(world.plan_calibration(pcfg.vocab_size))
pq = jcalibrate(lambda p_: pm.forward(p_, ptoks)[0],
                pm.quantize(pm.init(jax.random.PRNGKey(0)), JSpec(bw=1, ba=3, p=4, mode="lut")))
pplan = plan_model(params_from_numpy(pq, device="cpu"), lut_budget_bytes=world.PLAN_BUDGET,
                   n_hint=world.PLAN_BATCH, measure=False)
with open(sys.argv[4] + ".tmp", "wb") as f:
    pickle.dump({"tree": params_from_numpy(pq, device="cpu"), "plan": pplan.to_json()}, f)
os.replace(sys.argv[4] + ".tmp", sys.argv[4])

with open(sys.argv[1] + ".tmp", "wb") as f:      # the world's ranks wait for the file
    pickle.dump({"moe": spec, "params": jax.tree.map(np.asarray, p), "x": np.asarray(x),
                 "y": np.asarray(y), "aux": float(aux),
                 "train": {"tokens": tokens, "state": as_np(state), "loss": float(loss),
                           "grads": jax.tree.map(np.asarray, grads), "new": as_np(new)}}, f)
os.replace(sys.argv[1] + ".tmp", sys.argv[1])

# The reference's jitted prefill and decode steps with seq_shard, the caches
# placed by its cache_specs, on (1, 4) and (2, 2), over the inputs every rank
# of the world builds too (the port's seeded parameters).
import _torch_world as world
from repro.serve import serving

shapes = {"m4": (1, 4), "dm": (2, 2)}
seq_out = {}
for name, (arch, over, max_seq, s) in world.SEQ_CASES.items():
    cfg, inp = world._cfg(arch, get_config, **over), world.seq_inputs(name)
    tm = build_model(cfg)
    b = inp["tokens"].shape[0]
    for m in world.SEQ_MESHES:
        smesh = jax.sharding.Mesh(np.array(jax.devices()[:4]).reshape(shapes[m]),
                                  ("data", "model"))
        sctx = shd.ShardCtx(mesh=smesh, dp_axes=("data",), tp_axis="model", seq_shard=True)
        caches = tm.init_cache(b, max_seq, dtype=jnp.float32)
        c_shard = shd.to_shardings(shd.cache_specs(cfg, caches, sctx), smesh)
        rows = NamedSharding(smesh, P("data"))
        put = lambda a: None if a is None else jax.device_put(a, rows)
        ps = jax.device_put(inp["params"], shd.to_shardings(
            shd.param_specs(cfg, inp["params"], sctx), smesh))
        caches = jax.device_put(caches, c_shard)
        prefill = jax.jit(serving.make_prefill_step(tm, ctx=sctx), out_shardings=(None, c_shard))
        lg, caches = prefill(ps, put(inp["tokens"]), caches, put(inp["frames"]), put(inp["pad"]))
        # make_serve_step's body (its argmax left out: the logits are compared)
        step = jax.jit(lambda p_, t_, c_, pos_, pad_: tm.decode_step(
            p_, t_, c_, pos_, ctx=sctx, pad_len=pad_), out_shardings=(None, c_shard))
        logits = [np.asarray(lg)]
        for t in range(world.SEQ_STEPS):
            lg, caches = step(ps, put(inp["steps"][t]), caches, put(np.full((b,), s + t, np.int32)),
                              put(inp["pad"]))
            logits.append(np.asarray(lg))
        seq_out[(name, m)] = logits
with open(sys.argv[3], "wb") as f:
    pickle.dump(seq_out, f)

# The reference's unsharded ServeEngine(plan=) of the same tree and plan.
from repro.serve.serving import Request as JRequest, ServeEngine as JServeEngine
from repro.tune.plan import ModelPlan as JModelPlan

jplan = JModelPlan.from_json(pplan.to_json())
plan_out = {}
for d in world.PLAN_DRIVERS:
    eng = JServeEngine(pm, pq, batch=world.PLAN_BATCH, max_seq=world.PLAN_MAX_SEQ, decode=d,
                       plan=jplan)
    toks = eng.generate([JRequest(prompt=p_, max_new_tokens=m)
                         for p_, m in world.plan_requests(pcfg.vocab_size)])
    plan_out[d] = {"tokens": [list(map(int, t)) for t in toks],
                   "admissions": list(eng.admissions), "host_syncs": eng.host_syncs}
with open(sys.argv[5], "wb") as f:
    pickle.dump(plan_out, f)
"""


@pytest.fixture(scope="module")
def world_dir(tmp_path_factory):
    """The world's directory: the reference child's files and the world's
    (each rank's results, the checkpoints).  The child and the world run
    side by side: the ranks run the cases that need nothing of the child
    first, then wait for ``ref_ep.pkl``; the child writes it, then the
    reference's sequence-sharded steps (``ref_seq.pkl``)."""
    import multiprocessing as mp

    out = tmp_path_factory.mktemp("world")
    here = os.path.dirname(__file__)
    env = {**os.environ, "XLA_FLAGS": "--xla_force_host_platform_device_count=4",
           "JAX_PLATFORMS": "cpu",
           "PYTHONPATH": os.pathsep.join([os.path.join(here, "..", "src"), here])}
    with open(out / "ref.err", "w") as err:
        child = subprocess.Popen([sys.executable, "-c", textwrap.dedent(REF_EP),
                                  str(out / "ref_ep.pkl"), str(out / "ref_ckpt"),
                                  str(out / "ref_seq.pkl"), str(out / "ref_plan_tree.pkl"),
                                  str(out / "ref_plan.pkl")],
                                 env=env, stdout=subprocess.DEVNULL, stderr=err)
    try:
        world_results = _run_world(mp, out)
        child.wait(TIMEOUT_S)
    finally:
        if child.poll() is None:
            child.kill()
            child.wait()
    assert child.returncode == 0, (out / "ref.err").read_text()
    return out, world_results


def _run_world(mp, out):
    """Spawn the world's ranks over ``out``; returns each rank's results."""
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


@pytest.fixture(scope="module")
def ranks(world_dir):
    """Every rank's results."""
    return world_dir[1]


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


def test_mesh_runs_cache_free_steps_alike_under_seq_shard(ranks):
    """A cache-free forward and a train step on (2, 2): with ``seq_shard``
    they are the steps without it, bit for bit.  A call over caches without
    ``max_seq``, or with another than the caches', is refused."""
    for res in ranks:
        got = res["seq_steps"]
        assert got["forward_equal"] and got["step_equal"], got
        assert "needs max_seq=" in got["no_max_seq"], got
        assert "cut dim 2 to 512" in got["other_max_seq"], got


@pytest.fixture(scope="module")
def ref_seq(world_dir):
    """The reference's jitted sequence-sharded steps: ``{(case, mesh): [the
    prefill's logits, then each decode step's]}``."""
    return pickle.loads((world_dir[0] / "ref_seq.pkl").read_bytes())


@pytest.fixture(scope="module")
def ref_plan(world_dir):
    """The reference's unsharded ``ServeEngine(plan=)`` per driver: tokens,
    admissions, host syncs."""
    return pickle.loads((world_dir[0] / "ref_plan.pkl").read_bytes())


def test_rank_plan_is_the_plan_the_reference_serves(ranks):
    """Each rank's analytic plan of the global raw tree is the plan the JAX
    child made with the port's planner and the reference served: JSON for
    JSON."""
    for res in ranks:
        assert res["plan_serve"]["plan"] == res["plan_serve"]["child_plan"]


@pytest.mark.parametrize("driver", world.PLAN_DRIVERS)
@pytest.mark.parametrize("mesh", world.PLAN_MESHES)
def test_planned_sharded_serve_equals_reference_unsharded(ranks, ref_plan, mesh, driver):
    """``ServeEngine(plan=, ctx=)`` over each rank's raw shard gives the
    reference's unsharded planned serve's tokens, admissions and host syncs
    (the int-lut family is integer-exact and the ``lut`` shards are
    bit-equal to the unsharded layer), one host sync a wave or chunk."""
    want = ref_plan[driver]
    for r, res in enumerate(ranks):
        got = res["plan_serve"][(mesh, driver)]
        assert [list(map(int, t)) for t in got["tokens"]] == want["tokens"], (r, mesh, driver)
        assert got["admissions"] == [tuple(a) for a in want["admissions"]], (r, got)
        assert got["host_syncs"] == want["host_syncs"], (r, got)
        assert got["prepared"] > 0, got          # the plan prepared some leaves
        if driver == "scan":
            assert got["host_syncs"] == got["waves"], got


def test_sharded_serve_refuses_a_plan_that_does_not_match(ranks):
    """A plan made on a rank's own shard hashes the local codes shapes: every
    rank refuses it with the reference's message, and no rank hangs."""
    for res in ranks:
        for m in world.PLAN_MESHES:
            msg = res["plan_serve"][(m, "refused")]
            assert msg is not None and "does not match the parameter tree" in msg, (m, msg)


@pytest.mark.parametrize("case", ["one_rank", "one_rank_raises"])
def test_sharded_serve_refusal_on_one_rank_reaches_every_rank(ranks, case):
    """Rank 0 alone is handed a plan that does not match (``one_rank``), or
    its own check raises (``one_rank_raises``): rank 0 raises its own error,
    every other rank refuses the plan for it, and none hangs in the
    collective."""
    own = {"one_rank": "ValueError: plan fingerprint 00000000000000000000000000000000 does "
                       "not match the parameter tree",
           "one_rank_raises": "RuntimeError: the global shapes could not be rebuilt"}[case]
    for r, res in enumerate(ranks):
        for m in world.PLAN_MESHES:
            msg = res["plan_serve"][(m, case)]
            assert msg is not None, (r, m)
            if r == 0:
                assert msg.startswith(own), (m, msg)
            else:
                assert msg.startswith("ValueError: plan fingerprint") and \
                    msg.endswith("(on another rank of the mesh)"), (r, m, msg)


@pytest.mark.parametrize("mesh", world.PLAN_MESHES)
def test_planned_shards_hold_the_plans_bytes_for_them(ranks, mesh):
    """Each rank's prepared bytes are the plan's per-leaf bytes times the share
    of each leaf's codes it holds (the engine's own check agrees); over a TP
    group they sum to the plan's bytes with each replicated leaf once a
    rank."""
    for res in ranks:
        for d in world.PLAN_DRIVERS:
            got = res["plan_serve"][(mesh, d)]
            assert got["bytes"] == got["want_bytes"] == got["plan_bytes"] > 0, got
            assert got["tp_sum"] == got["want_tp_sum"], got


@pytest.mark.parametrize("mesh", world.SEQ_MESHES)
@pytest.mark.parametrize("case", sorted(world.SEQ_CASES))
def test_seq_shard_steps_equal_unsharded_and_reference(ranks, ref_seq, case, mesh):
    """Caches cut along the sequence on the TP axis (tp 4 on (1, 4), tp 2 on
    (2, 2)): every rank's prefill and teacher-forced decode logits within
    ``TOL_SEQ`` x max |logit| of the port's unsharded calls and of the
    reference's jitted ``make_prefill_step`` / decode step with its caches
    placed by ``cache_specs`` (the int8 cache against the reference:
    ``TOL_SEQ_INT8``).  Finite everywhere: at tp 4 the prompt's keys leave the
    last shard without a valid key for any row (and the decode steps' rows
    too)."""
    tol_ref = TOL_SEQ_INT8 if case.endswith("/int8") else TOL_SEQ
    for r, res in enumerate(ranks):
        got = res["seq"][case][mesh]
        lo, hi = got["rows"]
        assert got["cut"] > 0, (r, got["cut"])           # the caches were cut
        for i, (a, u, j) in enumerate(zip(got["logits"], res["seq"][case]["unsharded"],
                                          ref_seq[(case, mesh)])):
            assert np.isfinite(a).all(), (r, i)
            scale = np.abs(u).max()
            assert np.abs(a - u[lo:hi]).max() <= TOL_SEQ * scale, (r, i, "port")
            assert np.abs(a - j[lo:hi]).max() <= tol_ref * np.abs(j).max(), (r, i, "reference")


@pytest.mark.parametrize("driver", world.SERVE_DRIVERS)
@pytest.mark.parametrize("case", sorted(world.SEQ_CASES))
def test_seq_shard_serve_equals_unsharded(ranks, case, driver):
    """``ServeEngine(ctx=)`` with ``seq_shard`` (the continuous driver on (1, 4)
    and (2, 2), the loop on (2, 2), the chunked driver on (1, 4)): the
    unsharded engine's tokens, admissions, buckets and host syncs."""
    for res in ranks:
        s = res["seq_serve"][(case, driver)]
        for m in world.SEQ_SERVE_MESHES[driver]:
            assert s[m] == s["unsharded"], (m, s[m], s["unsharded"])


@pytest.mark.parametrize("case", sorted(world.TRAIN_CASES))
def test_sharded_train_step_equals_unsharded(ranks, case):
    """FSDP + TP on (data 2, model 2): each rank's gradient shards are the
    same slices of the unsharded step's gradient on the global batch within
    rounding — 1e-5 x the leaf's max |g|, or where the unsharded gradient
    itself moves more when its matmuls' sums are split as TP splits them,
    twice that move (``_torch_world._grad_bound``) — and the step's loss,
    grad_norm and parameters follow."""
    for r, res in enumerate(ranks):
        t = res["train"][case]
        assert t["sharded"] and t["step"] == 1, (r, t)
        assert t["grad_ratio"] <= 1.0, (r, t)
        assert t["loss_rel"] <= TOL_STEP and t["grad_norm_rel"] <= TOL_STEP, (r, t)
        assert t["param_abs"] <= TOL_PARAM, (r, t)


def test_sharded_train_step_matches_reference_local_step(ranks):
    """chatglm3-6b smoke, the reference's state and batch: the port's sharded
    step against the reference's jitted local step (its own test's bounds,
    and the cross-package gradient bound)."""
    got = {k: max(res["train"]["chatglm3-6b"][k] for res in ranks)
           for k in ("ref_loss_abs", "ref_grad_rel", "ref_param_abs")}
    assert got["ref_loss_abs"] < TOL_REF_LOSS, got
    assert got["ref_grad_rel"] <= TOL_REF_GRAD, got
    assert got["ref_param_abs"] <= TOL_PARAM, got


@pytest.mark.parametrize("mesh", world.ELASTIC_MESHES)
def test_elastic_restore_of_reference_save(ranks, mesh):
    """The reference's save of its stepped chatglm3-6b train state, made on
    its (data 2, model 2) mesh, restored by the port with
    ``restore(shardings=)`` on (2, 2), (4, 1) and (1, 4): every rank's leaves
    are ``shard_tree`` of the converted state on that mesh, bit for bit.
    (The reference's own test re-meshes (4, 2) -> (2, 2), which needs 8
    ranks; both packages save whole leaves, so the files do not depend on
    the saving mesh, and the re-mesh is shown inside this world of 4.)"""
    for r, res in enumerate(ranks):
        e = res["elastic"][mesh]
        assert e["equal"] and e["sharded"] > 0, (r, e)


@pytest.mark.parametrize("writer", ["save", "AsyncCheckpointer"])
def test_sharded_save_equals_reference_save(world_dir, writer):
    """The port's sharded save from (2, 2) of the same state (``save`` and an
    ``AsyncCheckpointer``): the manifest and every leaf file byte-equal to
    the reference's; the reference restores it."""
    import filecmp

    from repro.ckpt import checkpoint as jck
    from repro.configs import get_config as jget_config
    from repro.models.model import build_model as jbuild
    from repro.train import train_step as jts

    out, _ = world_dir
    port = out / ("port_ckpt" if writer == "save" else "port_async")
    step = f"step_{world.REF_STEP:09d}"
    dj, dt = out / "ref_ckpt" / step, port / step
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt)) and "manifest.json" in names
    assert all(filecmp.cmp(dj / n, dt / n, shallow=False) for n in names)
    jcfg = dataclasses.replace(jget_config("chatglm3-6b", smoke=True), dtype="float32")
    like = jax.eval_shape(lambda: jts.init_train_state(jbuild(jcfg), jax.random.PRNGKey(0)))
    back = jck.restore(str(port), world.REF_STEP, like)
    want = jck.restore(str(out / "ref_ckpt"), world.REF_STEP, like)
    for a, b in zip(jax.tree.leaves(back), jax.tree.leaves(want)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))


def test_launcher_trains_sharded_under_supervision(ranks):
    """``launch/train.py``'s body on (2, 2), 4 steps, a failure at step 2: one
    restart, the state bit-equal to a clean sharded run's, the losses those
    of the unsharded launcher; ``--mesh single`` in a world of 4 refuses
    with ``make_production_mesh``'s message."""
    for r, res in enumerate(ranks):
        lc = res["launch"]
        assert lc["restarts"] == 1 and lc["step"] == 4 and lc["bit_equal"], (r, lc)
        assert lc["loss_abs"] <= TOL_LAUNCH, (r, lc)
        assert lc["faulty_losses"][-2:] == lc["losses"][-2:], (r, lc)
        assert "need 256 devices for mesh (16, 16); have 4 ranks" in lc["refusal"], (r, lc)
