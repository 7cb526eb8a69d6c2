"""The port's data pipeline (``repro_torch.data.pipeline``) against the
JAX package's: batches byte for byte, for several (seed, step, shard),
from the synthetic source and from a token file, and through the
prefetch iterator; the numpy-2.0 zipf draw against ``rng.zipf`` itself.
The reference's three data tests of ``tests/test_substrates.py`` are
repeated on the port."""
import numpy as np
import pytest

from repro.data import pipeline as J
from repro_torch.data import pipeline as T


def both(**kw):
    return J.Pipeline(J.DataConfig(**kw)), T.Pipeline(T.DataConfig(**kw))


@pytest.mark.parametrize("seed,step,shard,num_shards,batch,seq,vocab", [
    (0, 0, 0, 1, 4, 64, 1000), (7, 13, 0, 1, 4, 64, 1000),
    (1, 5, 1, 2, 2, 32, 50_000), (3, 250, 3, 4, 8, 256, 49_155),
    (0, 59, 0, 1, 8, 256, 32_000)])
def test_synthetic_batches_equal_reference(seed, step, shard, num_shards,
                                           batch, seq, vocab):
    jp, tp = both(vocab_size=vocab, batch=batch, seq_len=seq, seed=seed,
                  shard_id=shard, num_shards=num_shards)
    want, got = jp.batch_at(step), tp.batch_at(step)
    assert got.dtype == want.dtype == np.int32
    assert got.tobytes() == want.tobytes()


def test_zipf_leaves_the_generator_where_rng_zipf_does():
    """numpy 2.0's sampler, as ``_Synthetic`` draws it: equal samples,
    and the next draws from the generator agree."""
    for seed in range(8):
        a = np.random.default_rng(seed)
        b = np.random.default_rng(seed)
        want = a.zipf(1.3, size=(4, 512)).astype(np.int64)
        got = T._zipf(b, 1.3, 4 * 512, T._NO_CAP).reshape(4, 512)
        np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(b.integers(0, 1 << 30, 16),
                                      a.integers(0, 1 << 30, 16))


def test_file_source_equals_reference(tmp_path):
    path = str(tmp_path / "tokens.bin")
    toks = np.random.default_rng(0).integers(0, 1000, 10_000).astype(np.int32)
    mm = np.memmap(path, dtype=np.int32, mode="w+", shape=toks.shape)
    mm[:] = toks
    mm.flush()
    for shard in (0, 1):
        jp, tp = both(vocab_size=1000, batch=4, seq_len=64, path=path,
                      shard_id=shard, num_shards=2)
        for step in (0, 3, 40):
            assert tp.batch_at(step).tobytes() == jp.batch_at(step).tobytes()


def test_prefetch_iterator_equals_reference():
    jp, tp = both(vocab_size=100, batch=2, seq_len=16, seed=4)
    it = tp.iterate(5)
    got = [next(it) for _ in range(4)]
    tp.close()
    for i, b in enumerate(got):
        assert b.tobytes() == jp.batch_at(5 + i).tobytes()


def test_data_deterministic():
    cfg = T.DataConfig(vocab_size=1000, batch=4, seq_len=64, seed=7)
    p = T.Pipeline(cfg)
    b1 = p.batch_at(13)
    b2 = p.batch_at(13)
    np.testing.assert_array_equal(b1, b2)
    assert b1.shape == (4, 64)
    assert b1.max() < 1000


def test_data_shards_disjoint():
    a = T.Pipeline(T.DataConfig(vocab_size=1000, batch=4, seq_len=64,
                                shard_id=0, num_shards=2)).batch_at(3)
    b = T.Pipeline(T.DataConfig(vocab_size=1000, batch=4, seq_len=64,
                                shard_id=1, num_shards=2)).batch_at(3)
    assert not np.array_equal(a, b)


def test_data_prefetch_iterator():
    cfg = T.DataConfig(vocab_size=100, batch=2, seq_len=16)
    p = T.Pipeline(cfg)
    it = p.iterate(0)
    b0 = next(it)
    next(it)
    p.close()
    np.testing.assert_array_equal(b0, p.batch_at(0))
