"""Port parity: repro_torch.ckpt.checkpoint against the JAX reference's
repro.ckpt.checkpoint (CPU).  The generic format (round trip, crash
atomicity, the async writer, structure validation) mirrors
tests/test_checkpoint.py; prepared checkpoints of the same f32 tree have equal
manifests and leaf files in both packages, and each package restores the
other's; bf16 leaves round-trip in the port; torn checkpoints are refused."""

import dataclasses
import filecmp
import json
import os

import numpy as np
import pytest

jax = pytest.importorskip("jax")
jnp = pytest.importorskip("jax.numpy")
torch = pytest.importorskip("torch")

from repro.ckpt import checkpoint as jck  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.core import LutLinearSpec as JSpec  # noqa: E402
from repro.models.model import build_model as jbuild  # noqa: E402
from repro_torch.ckpt import checkpoint as ckpt  # noqa: E402
from repro_torch.configs import get_config  # noqa: E402
from repro_torch.convert import params_from_numpy  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.serving import Request, ServeEngine  # noqa: E402
from repro_torch.tune.plan import param_fingerprint, quantized_leaf_items  # noqa: E402


def _np_tree(seed=0):
    rng = np.random.default_rng(seed)
    return {
        "a": rng.normal(size=(4, 5)).astype(np.float32),
        "nested": {"b": np.arange(7, dtype=np.int32), "c": np.float32(3.5)},
        "lst": [np.ones((2,), np.float32), np.zeros((3,), np.float32)],
    }


def _tree(seed=0):
    return jax.tree.map(lambda a: torch.from_numpy(np.array(a)), _np_tree(seed))


def _jtree(seed=0):
    return jax.tree.map(jnp.asarray, _np_tree(seed))


def _like():
    return jax.tree.map(lambda a: torch.empty(np.shape(a), dtype=torch.from_numpy(np.array(a)).dtype,
                                              device="meta"), _np_tree())


def _leaves(tree) -> list:
    """A tree's leaves as numpy arrays in jax's order (bf16 as its int16
    payload): the port's trees through the checkpoint's own flatten, the
    reference's through jax's."""
    if any(isinstance(x, torch.Tensor) for x in ckpt._flatten(tree, [])):
        return [ckpt._to_host(x) for x in ckpt._flatten(tree, [])]
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def _assert_tree_equal(a, b):
    la, lb = _leaves(a), _leaves(b)
    assert len(la) == len(lb)
    for x, y in zip(la, lb):
        np.testing.assert_array_equal(x, y)


# --- the generic format (mirrors tests/test_checkpoint.py) -----------------


def test_roundtrip(tmp_path):
    t = _tree()
    ckpt.save(str(tmp_path), 7, t)
    assert ckpt.latest_step(str(tmp_path)) == 7
    out = ckpt.restore(str(tmp_path), 7, _like(), device="cpu")
    _assert_tree_equal(t, out)
    assert out["nested"]["b"].dtype == torch.int32 and out["a"].device.type == "cpu"


def test_uncommitted_checkpoint_ignored(tmp_path):
    d = ckpt.save(str(tmp_path), 3, _tree())
    os.remove(os.path.join(d, "_COMMITTED"))  # simulate torn write
    assert ckpt.latest_step(str(tmp_path)) is None
    with pytest.raises(FileNotFoundError):
        ckpt.restore(str(tmp_path), 3, _like(), device="cpu")


def test_latest_of_many_and_gc(tmp_path):
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep_last=2)
    for s in (1, 2, 3, 4):
        w.save(s, _tree(s))
    w.wait()
    assert ckpt.latest_step(str(tmp_path)) == 4
    kept = sorted(n for n in os.listdir(tmp_path) if n.startswith("step_"))
    assert len(kept) == 2  # GC kept the last two
    _assert_tree_equal(_tree(4), ckpt.restore(str(tmp_path), 4, _like(), device="cpu"))


def test_async_snapshot_is_taken_at_save(tmp_path):
    """The caller may write into its tensors after save(): the checkpoint
    holds the values of the save() call."""
    t = _tree()
    w = ckpt.AsyncCheckpointer(str(tmp_path))
    w.save(1, t)
    t["a"].add_(1.0)
    w.wait()
    _assert_tree_equal(_tree(), ckpt.restore(str(tmp_path), 1, _like(), device="cpu"))


def test_latest_step_ignores_stray_entries(tmp_path):
    ckpt.save(str(tmp_path), 2, _tree())
    os.makedirs(tmp_path / "step_foo")
    os.makedirs(tmp_path / "step_000000009.tmp")
    (tmp_path / "step_abc").write_text("not a dir")
    (tmp_path / "notes.txt").write_text("x")
    assert ckpt.latest_step(str(tmp_path)) == 2
    w = ckpt.AsyncCheckpointer(str(tmp_path), keep_last=1)
    w.save(3, _tree(3))
    w.wait()                                  # GC walks the strays unfazed
    assert ckpt.latest_step(str(tmp_path)) == 3
    assert os.path.isdir(tmp_path / "step_foo")   # strays left alone


def test_async_writer_reraises_background_failure(tmp_path):
    base = tmp_path / "base-is-a-file"
    base.write_text("")                       # makedirs under it will fail
    w = ckpt.AsyncCheckpointer(str(base))
    w.save(1, _tree())
    with pytest.raises(RuntimeError, match="background checkpoint write") as ei:
        w.wait()
    assert ei.value.__cause__ is not None     # original OSError chained
    w2 = ckpt.AsyncCheckpointer(str(tmp_path / "ok"))
    w2.save(1, _tree())
    w2.wait()
    assert ckpt.latest_step(str(tmp_path / "ok")) == 1
    w3 = ckpt.AsyncCheckpointer(str(base))
    w3.save(1, _tree())
    with pytest.raises(RuntimeError, match="background checkpoint write"):
        w3.save(2, _tree())


def test_restore_validates_structure_against_like(tmp_path):
    ckpt.save(str(tmp_path), 5, _tree())
    with pytest.raises(ValueError, match="leaves"):
        ckpt.restore(str(tmp_path), 5, {"a": torch.empty((4, 5), device="meta")}, device="cpu")
    bad_shape = _like()
    bad_shape["a"] = torch.empty((5, 4), device="meta")
    with pytest.raises(ValueError, match="shape"):
        ckpt.restore(str(tmp_path), 5, bad_shape, device="cpu")
    bad_dtype = _like()
    bad_dtype["a"] = torch.empty((4, 5), dtype=torch.int32, device="meta")
    with pytest.raises(ValueError, match="dtype"):
        ckpt.restore(str(tmp_path), 5, bad_dtype, device="cpu")
    out = ckpt.restore(str(tmp_path), 5, bad_dtype, device="cpu", validate=False)
    assert out["a"].dtype == torch.float32          # the stored leaf, as the reference's
    _assert_tree_equal(_tree(), out)


def test_restore_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("this checks the refusal without a card")
    with pytest.raises(RuntimeError, match="cuda"):
        ckpt.restore("/nonexistent", 0, _like())


def test_generic_checkpoint_equals_reference_and_crosses(tmp_path):
    """The same tree saved by both packages: manifests equal (the treedef
    string too, for a tree of dicts and lists), leaf files byte-identical,
    and each package restores the other's."""
    dj = jck.save(str(tmp_path / "j"), 1, _jtree())
    dt = ckpt.save(str(tmp_path / "t"), 1, _tree())
    assert json.load(open(os.path.join(dj, "manifest.json"))) == \
        json.load(open(os.path.join(dt, "manifest.json")))
    names = sorted(os.listdir(dj))
    assert names == sorted(os.listdir(dt)) and len(names) == 5 + 2
    assert all(filecmp.cmp(os.path.join(dj, n), os.path.join(dt, n), shallow=False)
               for n in names)
    _assert_tree_equal(_tree(), ckpt.restore(str(tmp_path / "j"), 1, _like(), device="cpu"))
    _assert_tree_equal(_jtree(), jck.restore(str(tmp_path / "t"), 1,
                                             jax.eval_shape(lambda: _jtree())))


# --- prepared checkpoints -------------------------------------------------


def _lut_pair(dtype="float32"):
    """The live-ops test model (stablelm-12b smoke cut to 2 layers, width 32)
    in W1A3 p=2 lut, calibrated and prepared, in both packages."""
    kw = dict(name="live-ops-test", n_layers=2, d_model=32, n_heads=2, n_kv_heads=1,
              d_ff=64, vocab_size=64, dtype=dtype)
    jcfg = dataclasses.replace(jget_config("stablelm-12b", smoke=True), **kw)
    tcfg = dataclasses.replace(get_config("stablelm-12b", smoke=True), **kw)
    jm, tm = jbuild(jcfg), build_model(tcfg)
    jq = jm.quantize(jm.init(jax.random.PRNGKey(0)), JSpec(bw=1, ba=3, p=2, mode="lut"))
    cal = np.random.default_rng(7).integers(1, jcfg.vocab_size, (2, 8)).astype(np.int32)
    jp = jm.prepare(jq, calibrate=jnp.asarray(cal))
    tq = params_from_numpy(jax.tree.map(np.asarray, jq), device="cpu")
    return tcfg, jp, tm, tm.prepare(tq, calibrate=cal)


@pytest.fixture(scope="module")
def lut():
    return _lut_pair()


def _reqs(cfg, budgets=(6, 2, 4, 2), seed=3):
    rng = np.random.default_rng(seed)
    return [Request(prompt=rng.integers(1, cfg.vocab_size, 4 + i % 3).astype(np.int32),
                    max_new_tokens=m) for i, m in enumerate(budgets)]


def _serve(tm, tree, cfg):
    return ServeEngine(tm, tree, batch=2, max_seq=32, device="cpu").generate(_reqs(cfg))


def _leaf_paths(node, acc, path=""):
    """manifest leaf index -> the tree path of the array it holds."""
    if node["kind"] in ("prepared", "quantized"):
        acc.update({ref: f"{path}/{name}" for name, ref in node["arrays"].items()
                    if ref is not None})
    elif node["kind"] == "leaf":
        acc[node["array"]] = path
    else:
        items = node.get("items")
        for k, v in (items.items() if isinstance(items, dict) else enumerate(items or [])):
            _leaf_paths(v, acc, f"{path}/{k}")
    return acc


def _files_equal(da, db):
    names = sorted(os.listdir(da))
    assert names == sorted(os.listdir(db))
    return [n for n in names if not filecmp.cmp(os.path.join(da, n), os.path.join(db, n),
                                                shallow=False)]


def test_prepared_checkpoint_equals_reference_for_the_same_tree(tmp_path, lut):
    """The reference's calibrated prepared f32 tree, carried into the port as
    it is: manifest and every leaf file byte-identical.  The port's own
    prepare of the same raw tree: the same manifest (fingerprint, specs, p,
    pack keys, leaf shapes and dtypes), the same files but the frozen
    activation scales, which differ in the last f32 bit (ROADMAP Queue 3)."""
    _cfg, jp, _tm, tp = lut
    dj = jck.save_prepared(str(tmp_path / "j"), 0, jp)
    dc = ckpt.save_prepared(str(tmp_path / "c"), 0,
                            params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"))
    dt = ckpt.save_prepared(str(tmp_path / "t"), 0, tp)
    mj = json.load(open(os.path.join(dj, "manifest.json")))
    assert mj == json.load(open(os.path.join(dc, "manifest.json")))
    assert mj == json.load(open(os.path.join(dt, "manifest.json")))
    assert mj["fingerprint"] == param_fingerprint(tp) and len(mj["leaves"]) > 20
    assert _files_equal(dj, dc) == []
    paths = _leaf_paths(mj["tree"], {})
    differ = _files_equal(dj, dt)
    assert differ and all(paths[int(n[5:10])].endswith("/ascale") for n in differ)
    for n in differ:
        np.testing.assert_allclose(np.load(os.path.join(dt, n)), np.load(os.path.join(dj, n)),
                                   rtol=2**-21, atol=0)


def test_each_package_restores_the_others_prepared_checkpoint(tmp_path, lut):
    cfg, jp, tm, tp = lut
    ckpt.save_prepared(str(tmp_path / "t"), 0, tp)
    jck.save_prepared(str(tmp_path / "j"), 0, jp)
    # the reference restores the port's: every leaf equal, same fingerprint
    back = jck.restore_prepared(str(tmp_path / "t"), 0, expect_fingerprint=param_fingerprint(tp))
    from repro.tune.plan import quantized_leaf_items as jitems

    jl, tl = dict(jitems(back)), dict(quantized_leaf_items(tp))
    assert sorted(jl) == sorted(tl) and len(tl) == 7
    for path, leaf in tl.items():
        assert jl[path].p == leaf.p and jl[path].spec.mode == "lut"
        for name in ("codes", "scale", "wpk", "ascale"):
            np.testing.assert_array_equal(np.asarray(getattr(jl[path], name)),
                                          getattr(leaf, name).numpy())
    # the port restores the reference's and serves it with the converted tree's tokens
    restored = ckpt.restore_prepared(str(tmp_path / "j"), 0, device="cpu")
    converted = params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu")
    _assert_tree_equal(jp, restored)
    assert _serve(tm, restored, cfg) == _serve(tm, converted, cfg)


def test_prepared_roundtrip_serves_identically_and_keeps_calibration(tmp_path, lut):
    """The port's own tree: restored bit for bit (same dtypes, the frozen
    scales kept), the same fingerprint as the raw tree's, the same tokens;
    a wrong expected fingerprint is refused."""
    cfg, _jp, tm, tp = lut
    d = str(tmp_path / "prepared")
    ckpt.save_prepared(d, 0, tp)
    meta = ckpt.prepared_meta(d, 0)
    assert meta["fingerprint"] == param_fingerprint(tp) and meta["prepared_version"] == 2
    restored = ckpt.restore_prepared(d, 0, device="cpu", expect_fingerprint=meta["fingerprint"])
    for (pa, a), (pb, b) in zip(quantized_leaf_items(tp), quantized_leaf_items(restored)):
        assert pa == pb and a.spec == b.spec and (a.k, a.p) == (b.k, b.p)
        for name in ("codes", "scale", "wpk", "wcanon", "ascale"):
            x, y = getattr(a, name), getattr(b, name)
            assert (x is None) == (y is None)
            if x is not None:
                assert x.dtype == y.dtype and torch.equal(x, y)
    assert _serve(tm, restored, cfg) == _serve(tm, tp, cfg)
    with pytest.raises(ValueError, match="fingerprint"):
        ckpt.restore_prepared(d, 0, device="cpu", expect_fingerprint="deadbeef")


def test_restore_warms_the_pack_cache_and_stores_no_tables(tmp_path, lut):
    """The shared LUT tables are not in the checkpoint: the manifest names
    each layer's pack, and the restore rebuilds it and its device tables."""
    from repro_torch.core import engine
    from repro_torch.core.api import _lut_pack_cache

    _cfg, _jp, _tm, tp = lut
    d = ckpt.save_prepared(str(tmp_path), 0, tp)
    manifest = json.load(open(os.path.join(d, "manifest.json")))
    keys = {tuple(n["pack_key"]) for n in _prepared_nodes(manifest["tree"])}
    assert keys and all(k[:2] == (1, 3) for k in keys)
    stored = sum(os.path.getsize(os.path.join(d, n)) for n in os.listdir(d) if n.endswith(".npy"))
    arrays = sum(t.numel() * t.element_size() for t in ckpt._flatten(tp, []))
    assert stored - arrays == 128 * len(manifest["leaves"])   # one .npy header a leaf
    _lut_pack_cache.cache_clear()
    engine._TABLES.clear()
    ckpt.restore_prepared(str(tmp_path), 0, device="cpu")
    assert _lut_pack_cache.cache_info().currsize == len(keys)
    assert len(engine._TABLES) == len(keys)


def _prepared_nodes(node):
    if node["kind"] == "prepared":
        yield node
    items = node.get("items")
    for child in (items.values() if isinstance(items, dict) else items or []):
        yield from _prepared_nodes(child)


def _dense_to_bf16(tree, cast):
    """The tree with its dense float leaves (embedding, norms, head) cast by
    ``cast``; the quantized leaves untouched."""
    if isinstance(tree, dict):
        return {k: _dense_to_bf16(v, cast) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_dense_to_bf16(v, cast) for v in tree]
    if hasattr(tree, "dtype") and "float" in str(tree.dtype):
        return cast(tree)
    return tree


def test_bf16_prepared_checkpoint_roundtrips_in_the_port(tmp_path, lut):
    """A prepared tree with bf16 dense leaves: written as the reference
    writes them — the two-byte payload under descr '<V2', dtype "bfloat16"
    in the manifest, files byte-identical to the reference's save of the
    same tree — and read back as torch.bfloat16 bit for bit.  (The
    reference cannot read it back: ROADMAP Queue 3.)"""
    _cfg, jp, _tm, tp = lut
    tb = _dense_to_bf16(tp, lambda t: t.to(torch.bfloat16))
    jb = _dense_to_bf16(jp, lambda a: a.astype(jnp.bfloat16))
    assert tb["embed"].dtype == torch.bfloat16
    dt = ckpt.save_prepared(str(tmp_path / "t"), 0, tb)
    dc = ckpt.save_prepared(str(tmp_path / "c"), 0, _dense_to_bf16(
        params_from_numpy(jax.tree.map(np.asarray, jp), device="cpu"),
        lambda t: t.to(torch.bfloat16)))
    dj = jck.save_prepared(str(tmp_path / "j"), 0, jb)
    mj = json.load(open(os.path.join(dj, "manifest.json")))
    assert mj == json.load(open(os.path.join(dc, "manifest.json")))
    assert _files_equal(dj, dc) == []
    bf16 = [i for i, m in enumerate(mj["leaves"]) if m["dtype"] == "bfloat16"]
    assert len(bf16) >= 3
    with open(os.path.join(dt, f"leaf_{bf16[0]:05d}.npy"), "rb") as f:
        assert b"'descr': '<V2'" in f.read(128)
    restored = ckpt.restore_prepared(str(tmp_path / "t"), 0, device="cpu")
    assert restored["embed"].dtype == torch.bfloat16
    _assert_tree_equal(tb, restored)
    assert [x.dtype for x in ckpt._flatten(tb, [])] == [x.dtype for x in ckpt._flatten(restored, [])]
    with pytest.raises(TypeError):                    # the reference's own defect
        jck.restore_prepared(str(tmp_path / "j"), 0)


@pytest.mark.parametrize("variant", [0, 1, 2, "mid_data"])
def test_torn_prepared_checkpoint_is_refused(tmp_path, lut, variant):
    """The chaos sweep's torn checkpoints (missing _COMMITTED, a leaf cut to
    17 bytes, a corrupt manifest) and a leaf cut inside its data: every
    restore raises, none loads part of the tree."""
    from repro_torch.ft.chaos import _tear_checkpoint

    _cfg, _jp, _tm, tp = lut
    d = ckpt.save_prepared(str(tmp_path), 0, tp)
    if variant == "mid_data":
        leaf = os.path.join(d, "leaf_00000.npy")
        os.truncate(leaf, os.path.getsize(leaf) - 4)
        err = ValueError
    else:
        _tear_checkpoint(d, variant)
        err = FileNotFoundError if variant == 0 else ValueError
    with pytest.raises(err):
        ckpt.restore_prepared(str(tmp_path), 0, device="cpu")
    if variant == 0:
        assert ckpt.latest_step(str(tmp_path)) is None


def test_restore_prepared_refuses_plain_checkpoint(tmp_path):
    ckpt.save(str(tmp_path), 1, {"a": torch.zeros((2,))})
    with pytest.raises(ValueError, match="plain checkpoint"):
        ckpt.restore_prepared(str(tmp_path), 1, device="cpu")
    with pytest.raises(FileNotFoundError):
        ckpt.restore_prepared(str(tmp_path), 99, device="cpu")
    with pytest.raises(ValueError, match="not a prepared"):
        ckpt.prepared_meta(str(tmp_path), 1)
