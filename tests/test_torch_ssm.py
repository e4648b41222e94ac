"""Port parity: repro_torch.models.ssm (the Mamba2 SSD mixer) against the JAX
reference (repro.models.ssm) on numpy-seeded inputs at zamba2-7b's smoke
widths (CPU).

``ssm_apply`` in f32: a prefill from a zero state, a prefill onto a carried
state, and decode steps that continue it (the SSD state and the conv
history), each within 1e-4 x max |y| of the reference, the carried state
too; in bf16 within the distance bf16 alone puts the reference from its own
f32.  The softplus is the reference's ``logaddexp(x, 0)``."""

import dataclasses

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.configs import get_config as jget_config  # noqa: E402
from repro.models import ssm as jssm  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models import ssm as tssm  # noqa: E402

ARCH = "zamba2-7b"
TOL = 1e-4          # f32: the same sums in another order, relative to max |value|
B, S = 2, 11


def _cfgs(dtype="float32"):
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=dtype)
    tcfg = dataclasses.replace(get_config(ARCH, smoke=True), dtype=dtype)
    assert dataclasses.asdict(jcfg) == dataclasses.asdict(tcfg)
    return jcfg, tcfg


@pytest.fixture(scope="module")
def pair():
    """The reference's SSM block with a_log, dt_bias and d_skip drawn away
    from their init values (zeros and ones would hide a wrong sign or
    broadcast), carried across by convert."""
    jcfg, tcfg = _cfgs()
    jp = jax.tree.map(np.asarray, jssm.ssm_init(jcfg, jax.random.PRNGKey(0)))
    rng = np.random.default_rng(3)
    _, nh = jssm.ssm_dims(jcfg)
    jp = dict(jp, a_log=rng.normal(0, 0.5, nh).astype(np.float32),
              dt_bias=rng.normal(0, 1.0, nh).astype(np.float32),
              d_skip=rng.normal(1, 0.5, nh).astype(np.float32),
              conv_b=rng.normal(0, 0.1, jp["conv_b"].shape).astype(np.float32))
    return jcfg, tcfg, jp, params_from_numpy(jp, device="cpu")


def _x(cfg, shape, seed):
    return np.random.default_rng(seed).normal(size=shape + (cfg.d_model,)).astype(np.float32)


def _close(got, want, tol=TOL):
    want = np.asarray(want, dtype=np.float32)
    np.testing.assert_allclose(got.detach().float().numpy(), want, rtol=0,
                               atol=tol * np.abs(want).max())


def _tstate(cfg):
    return tssm.init_ssm_state(cfg, B, device="cpu")


def test_prefill_without_state_matches_reference(pair):
    jcfg, tcfg, jp, tp = pair
    x = _x(jcfg, (B, S), 1)
    jy, jst = jssm.ssm_apply(jp, jnp.asarray(x), jcfg)
    ty, tst = tssm.ssm_apply(tp, torch.from_numpy(x), tcfg)
    assert jst is None and tst is None
    _close(ty, jy)


def test_prefill_onto_carried_state_then_decode_matches_reference(pair):
    """A prefill onto a nonzero carried state (SSD state and conv history),
    then decode steps that continue it: outputs and the state after every
    call, against the reference's."""
    jcfg, tcfg, jp, tp = pair
    rng = np.random.default_rng(4)
    j0 = jssm.init_ssm_state(jcfg, B, jnp.float32)
    carried = {k: rng.normal(0, 0.5, v.shape).astype(np.float32) for k, v in j0.items()}
    jst = {k: jnp.asarray(v) for k, v in carried.items()}
    tst = _tstate(tcfg)
    for k, v in carried.items():
        tst[k].copy_(torch.from_numpy(v))
    ssd, conv = tst["ssd"], tst["conv"]
    x = _x(jcfg, (B, S), 5)
    jy, jst = jssm.ssm_apply(jp, jnp.asarray(x), jcfg, jst)
    ty, back = tssm.ssm_apply(tp, torch.from_numpy(x), tcfg, tst)
    assert back is tst and tst["ssd"] is ssd and tst["conv"] is conv    # written in place
    _close(ty, jy)
    for k in ("ssd", "conv"):
        _close(tst[k], jst[k])
    for t in range(4):
        xt = _x(jcfg, (B, 1), 10 + t)
        jy, jst = jssm.ssm_apply(jp, jnp.asarray(xt), jcfg, jst)
        ty, _ = tssm.ssm_apply(tp, torch.from_numpy(xt), tcfg, tst)
        _close(ty, jy)
        for k in ("ssd", "conv"):
            _close(tst[k], jst[k])


def test_prefill_equals_prefill_then_decode_in_the_port(pair):
    """The recurrence's one step function: a prefill of S tokens and a
    prefill of S - 3 followed by 3 decode steps give the same outputs and
    state within the f32 tolerance (the in/out projections see other row
    counts)."""
    _jcfg, tcfg, _jp, tp = pair
    x = torch.from_numpy(_x(tcfg, (B, S), 6))
    whole, split = _tstate(tcfg), _tstate(tcfg)
    y_whole, _ = tssm.ssm_apply(tp, x, tcfg, whole)
    ys = [tssm.ssm_apply(tp, x[:, : S - 3], tcfg, split)[0]]
    ys += [tssm.ssm_apply(tp, x[:, t : t + 1], tcfg, split)[0] for t in range(S - 3, S)]
    _close(torch.cat(ys, dim=1), y_whole.numpy())
    for k in ("ssd", "conv"):
        _close(split[k], whole[k].numpy())


def test_bf16_within_the_distance_bf16_puts_the_reference(pair):
    """In bf16 the conv and gate round op by op, the recurrence stays f32:
    the port's bf16 output (and carried state) lies within the distance
    bf16 alone puts the reference from its own f32 of the reference's bf16
    output."""
    jcfg, _tcfg, jp, tp = pair
    jb, tb = _cfgs("bfloat16")
    x = _x(jcfg, (B, S), 7)
    jf, jsf = jssm.ssm_apply(jp, jnp.asarray(x), jcfg, jssm.init_ssm_state(jcfg, B, jnp.float32))
    jh, jsh = jssm.ssm_apply(jp, jnp.asarray(x, jnp.bfloat16), jb,
                             jssm.init_ssm_state(jb, B, jnp.float32))
    tst = _tstate(tb)
    th, _ = tssm.ssm_apply(tp, torch.from_numpy(x).to(torch.bfloat16), tb, tst)
    assert th.dtype == torch.bfloat16 and tst["ssd"].dtype == torch.float32
    jf, jh = np.asarray(jf, np.float32), np.asarray(jh, np.float32)
    ref_dist = np.abs(jh - jf).max()
    assert 0 < ref_dist < 0.05 * np.abs(jf).max()
    assert np.abs(th.float().numpy() - jh).max() <= ref_dist
    for k in ("ssd", "conv"):
        want, jk = np.asarray(jsf[k], np.float32), np.asarray(jsh[k], np.float32)
        assert np.abs(tst[k].numpy() - jk).max() <= np.abs(jk - want).max()


def test_softplus_is_the_reference_logaddexp():
    x = np.linspace(-40, 40, 801).astype(np.float32)
    want = np.asarray(jax.nn.softplus(jnp.asarray(x)))
    np.testing.assert_allclose(tssm.softplus(torch.from_numpy(x)).numpy(), want,
                               rtol=2e-7, atol=1e-30)
