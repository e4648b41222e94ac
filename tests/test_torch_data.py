"""Port parity: the synthetic data pipeline (``repro_torch.data.pipeline``),
the mirror of tests/test_data.py, with every batch bit-equal to the JAX
reference's ``SyntheticLM`` (the same numpy counter-based generator)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.data.pipeline import DataConfig as JDataConfig  # noqa: E402
from repro.data.pipeline import SyntheticLM as JSyntheticLM  # noqa: E402
from repro_torch.data.pipeline import (  # noqa: E402
    DataConfig, PatternLM, Prefetcher, SyntheticLM, to_device,
)


def _both(cfg, step, **kw):
    got = SyntheticLM(DataConfig(**cfg), **kw).batch_at(step)
    want = JSyntheticLM(JDataConfig(**cfg), **kw).batch_at(step)
    assert sorted(got) == sorted(want)
    return got, want


@pytest.mark.parametrize("cfg,step,kw", [
    (dict(vocab_size=100, seq_len=16, global_batch=4, seed=7), 13, {}),
    (dict(vocab_size=151664, seq_len=512, global_batch=4), 0, {}),
    (dict(vocab_size=1000, seq_len=8, global_batch=8, seed=3), 5, dict(host_id=1, n_hosts=2)),
    (dict(vocab_size=512, seq_len=8, global_batch=2, prefix_seq=8, prefix_dim=32), 3, {}),
])
def test_batches_bit_equal_to_reference(cfg, step, kw):
    got, want = _both(cfg, step, **kw)
    for k in want:
        assert got[k].dtype == want[k].dtype
        np.testing.assert_array_equal(got[k], want[k])


def test_counter_based_determinism():
    cfg = DataConfig(vocab_size=100, seq_len=16, global_batch=4, seed=7)
    a = SyntheticLM(cfg).batch_at(13)
    b = SyntheticLM(cfg).batch_at(13)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    c = SyntheticLM(cfg).batch_at(14)
    assert not np.array_equal(a["tokens"], c["tokens"])


def test_restart_replays_same_stream():
    cfg = DataConfig(vocab_size=100, seq_len=8, global_batch=2)
    pipe = SyntheticLM(cfg)
    first = [b["tokens"] for _, b in zip(range(5), pipe.iterate(0))]
    resumed = [b["tokens"] for _, b in zip(range(3), pipe.iterate(2))]
    for a, b in zip(first[2:], resumed):
        np.testing.assert_array_equal(a, b)


def test_host_sharding_disjoint():
    cfg = DataConfig(vocab_size=1000, seq_len=8, global_batch=8, seed=3)
    h0 = SyntheticLM(cfg, host_id=0, n_hosts=2).batch_at(0)
    h1 = SyntheticLM(cfg, host_id=1, n_hosts=2).batch_at(0)
    assert h0["tokens"].shape == (4, 9)
    assert not np.array_equal(h0["tokens"], h1["tokens"])
    with pytest.raises(ValueError, match="divide"):
        SyntheticLM(DataConfig(vocab_size=10, seq_len=4, global_batch=3), n_hosts=2)


@pytest.mark.parametrize("device", [None, "cpu"])
def test_prefetcher_delivers_in_order(device):
    """Without a device the batches come as numpy (the reference's
    ``sharding=None``); with one, as tensors on it, equal to the numpy."""
    cfg = DataConfig(vocab_size=50, seq_len=4, global_batch=2, prefix_seq=3, prefix_dim=8)
    pipe = SyntheticLM(cfg)
    pf = Prefetcher(pipe.iterate(0), depth=2, device=device)
    got = [next(pf) for _ in range(4)]
    pf.stop()
    for i, g in enumerate(got):
        want = pipe.batch_at(i)
        for k in want:
            if device is None:
                assert isinstance(g[k], np.ndarray)
            else:
                assert isinstance(g[k], torch.Tensor) and g[k].device.type == device
            np.testing.assert_array_equal(np.asarray(g[k]), want[k])


def test_prefix_embeds_present_for_frontend():
    cfg = DataConfig(vocab_size=50, seq_len=4, global_batch=2, prefix_seq=3, prefix_dim=8)
    b = SyntheticLM(cfg).batch_at(0)
    assert b["prefix_embeds"].shape == (2, 3, 8) and b["prefix_embeds"].dtype == np.float32


def test_to_device_keeps_values_and_refuses_a_missing_card():
    cfg = DataConfig(vocab_size=50, seq_len=4, global_batch=2, prefix_seq=3, prefix_dim=8)
    b = SyntheticLM(cfg).batch_at(1)
    t = to_device(b, "cpu")
    assert t["tokens"].dtype == torch.int32 and t["prefix_embeds"].dtype == torch.float32
    np.testing.assert_array_equal(t["tokens"].numpy(), b["tokens"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="is_available"):
            to_device(b, "cuda")


def test_pattern_stream_counts_up_and_replays():
    """``PatternLM``: each row counts up modulo the vocabulary from a seeded
    start (the next token is a function of the current one); batch i is a
    pure function of (seed, i), with the frontend's embeddings drawn too."""
    cfg = DataConfig(vocab_size=64, seq_len=12, global_batch=3, prefix_seq=2, prefix_dim=4)
    a, b = PatternLM(cfg).batch_at(4), PatternLM(cfg).batch_at(4)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    t = a["tokens"]
    assert t.shape == (3, 13) and t.dtype == np.int32
    np.testing.assert_array_equal(t[:, 1:], (t[:, :-1] + 1) % 64)
    assert a["prefix_embeds"].shape == (3, 2, 4)
    assert not np.array_equal(PatternLM(cfg).batch_at(5)["tokens"], t)
