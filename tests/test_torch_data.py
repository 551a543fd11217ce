"""Port parity for the data pipeline: the port's ``TokenStream`` batches
are the reference's bit for bit (the same numpy generator keyed on
(seed, step, host)), for several configs, steps and hosts, and the
reference's TokenStream and bucket-buffer cases
(``tests/test_scheduler_data.py:102-143``) run on the port.  The
pipeline is numpy only: every comparison is exact."""
import numpy as np
import pytest

pytest.importorskip("torch")

from repro.data import pipeline as jpipe  # noqa: E402
from repro_torch.data.pipeline import (BucketReorderBuffer,  # noqa: E402
                                       DataConfig, TokenStream)


@pytest.mark.parametrize("vocab,seq,batch,hosts,seed", [
    (100, 16, 8, 2, 0), (151936, 512, 8, 1, 0), (51865, 128, 4, 1, 3),
    (256, 32, 6, 3, 7)])
def test_tokenstream_batches_equal_the_reference(vocab, seq, batch, hosts,
                                                 seed):
    for host in range(hosts):
        kw = dict(vocab=vocab, seq_len=seq, global_batch=batch,
                  n_hosts=hosts, host_id=host, seed=seed)
        ours = TokenStream(DataConfig(**kw), start_step=2)
        ref = jpipe.TokenStream(jpipe.DataConfig(**kw), start_step=2)
        for _ in range(3):
            a, b = next(ours), next(ref)
            assert a.keys() == b.keys()
            for k in a:
                assert a[k].dtype == b[k].dtype == np.int32
                np.testing.assert_array_equal(a[k], b[k])


def test_bucket_buffer_equals_the_reference():
    rng = np.random.default_rng(4)
    samples = [np.arange(n, dtype=np.int32) for n in
               rng.integers(10, 3000, 200)]
    ours, ref = BucketReorderBuffer(window=64), \
        jpipe.BucketReorderBuffer(window=64)
    for s in samples:
        assert ours.offer(s) == ref.offer(s)
    while True:
        a, b = ours.take_batch(8), ref.take_batch(8)
        assert (a is None) == (b is None)
        if a is None:
            break
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)


# ---- the reference's cases (tests/test_scheduler_data.py:102-143) ---------
def test_tokenstream_deterministic_and_sharded():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=8, n_hosts=2,
                     host_id=0)
    a = next(TokenStream(cfg))
    b = next(TokenStream(cfg))
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    cfg1 = DataConfig(vocab=100, seq_len=16, global_batch=8, n_hosts=2,
                      host_id=1)
    c = next(TokenStream(cfg1))
    assert not np.array_equal(a["tokens"], c["tokens"])
    assert a["tokens"].shape == (4, 16)
    # next-token alignment
    full = next(TokenStream(cfg, start_step=0))
    np.testing.assert_array_equal(full["tokens"][:, 1:],
                                  full["labels"][:, :-1])


def test_tokenstream_resume():
    cfg = DataConfig(vocab=100, seq_len=16, global_batch=4)
    s = TokenStream(cfg)
    next(s)
    second = next(s)
    resumed = next(TokenStream(cfg, start_step=1))
    np.testing.assert_array_equal(second["tokens"], resumed["tokens"])


def test_bucket_buffer_reduces_padding():
    rng = np.random.default_rng(0)
    lens = rng.integers(10, 2000, 256)
    samples = [np.ones(n, np.int32) for n in lens]
    buf = BucketReorderBuffer(window=256)
    for s in samples:
        assert buf.offer(s)
    waste = []
    while True:
        out = buf.take_batch(16)
        if out is None:
            break
        arr, mask = out
        waste.append(1.0 - mask.mean())
    # naive batching pads everything to 2048
    naive = 1.0 - lens.mean() / 2048
    assert np.mean(waste) < 0.6 * naive
