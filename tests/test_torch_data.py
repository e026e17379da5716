"""repro_torch.data against the JAX reference (repro.data) on the CPU:
``SyntheticLM`` and ``MemmapCorpus`` batches equal the reference's bit for
bit over steps, seeds and shards, the elastic reshard included; then the
reference's own data tests (tests/test_data.py) case for case on the port.
No tolerance: the batches are integer tokens from the counter RNG, which
is bit-exact."""
import numpy as np
import pytest

from repro_torch.data import DataConfig, MemmapCorpus, SyntheticLM, \
    write_corpus

try:
    import jax  # noqa: F401

    from repro import data as j_data
except ModuleNotFoundError:     # a CUDA host may have no JAX installed
    j_data = None


@pytest.fixture(scope="module", autouse=True)
def reference():
    if j_data is None:
        pytest.skip("needs the JAX reference package `repro`, and JAX is "
                    "not installed")


def _same(got, want):
    assert list(got) == list(want) == ["tokens", "labels"]
    for k in got:
        assert got[k].dtype == want[k].dtype == np.int32, k
        np.testing.assert_array_equal(got[k], want[k])


@pytest.mark.parametrize("vocab,seq,batch,seed", [(1000, 32, 8, 5),
                                                  (32001, 64, 2, 0),
                                                  (512, 17, 4, 123)])
def test_synthetic_equals_reference(vocab, seq, batch, seed):
    kw = dict(vocab=vocab, seq_len=seq, global_batch=batch, seed=seed)
    for step in (0, 1, 13, 1000):
        _same(SyntheticLM(DataConfig(**kw)).batch(step),
              j_data.SyntheticLM(j_data.DataConfig(**kw)).batch(step))


@pytest.mark.parametrize("shards", [2, 4])
def test_synthetic_shards_equal_reference(shards):
    for sid in range(shards):
        kw = dict(vocab=500, seq_len=8, global_batch=8, seed=2,
                  num_shards=shards, shard_id=sid)
        _same(SyntheticLM(DataConfig(**kw)).batch(3),
              j_data.SyntheticLM(j_data.DataConfig(**kw)).batch(3))


def test_memmap_equals_reference(tmp_path):
    path = str(tmp_path / "corpus.bin")
    write_corpus(path, np.random.default_rng(0).integers(0, 1000,
                                                         size=10000))
    ref = str(tmp_path / "ref.bin")
    j_data.write_corpus(ref, np.random.default_rng(0).integers(0, 1000,
                                                               size=10000))
    assert open(path, "rb").read() == open(ref, "rb").read()
    for shards in (1, 2):
        for sid in range(shards):
            kw = dict(vocab=1000, seq_len=64, global_batch=4, seed=3,
                      num_shards=shards, shard_id=sid)
            for step in (0, 5, 77):
                _same(MemmapCorpus(path, DataConfig(**kw)).batch(step),
                      j_data.MemmapCorpus(path, j_data.DataConfig(**kw))
                      .batch(step))


# --- the reference's data tests, on the port ------------------------------------

def test_synthetic_deterministic_replay():
    cfg = DataConfig(vocab=1000, seq_len=32, global_batch=8, seed=5)
    a, b = SyntheticLM(cfg).batch(13), SyntheticLM(cfg).batch(13)
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    np.testing.assert_array_equal(a["labels"], b["labels"])
    assert not np.array_equal(a["tokens"], SyntheticLM(cfg).batch(14)
                              ["tokens"])


def test_labels_are_shifted_tokens():
    b = SyntheticLM(DataConfig(vocab=100, seq_len=16,
                               global_batch=4)).batch(0)
    np.testing.assert_array_equal(b["tokens"][:, 1:], b["labels"][:, :-1])


def test_sharding_partitions_global_batch():
    cfg = DataConfig(vocab=1000, seq_len=16, global_batch=8, seed=1)
    whole = SyntheticLM(cfg).batch(3)
    parts = [SyntheticLM(DataConfig(vocab=1000, seq_len=16, global_batch=8,
                                    seed=1, num_shards=2, shard_id=i)
                         ).batch(3) for i in range(2)]
    np.testing.assert_array_equal(
        whole["tokens"], np.concatenate([p["tokens"] for p in parts]))


def test_elastic_reshard_same_examples():
    """4 shards and 2 shards produce the same global example set."""
    def allb(n):
        return np.concatenate([
            SyntheticLM(DataConfig(vocab=500, seq_len=8, global_batch=8,
                                   seed=2, num_shards=n, shard_id=i)
                        ).batch(0)["tokens"] for i in range(n)])
    np.testing.assert_array_equal(allb(2), allb(4))


def test_memmap_corpus(tmp_path):
    path = str(tmp_path / "corpus.bin")
    write_corpus(path, np.random.default_rng(0).integers(0, 1000,
                                                         size=10000))
    cfg = DataConfig(vocab=1000, seq_len=64, global_batch=4, seed=3)
    a = MemmapCorpus(path, cfg).batch(5)
    b = MemmapCorpus(path, cfg).batch(5)       # restart-exact
    np.testing.assert_array_equal(a["tokens"], b["tokens"])
    assert a["tokens"].shape == (4, 64)
    assert a["tokens"].min() >= 0 and a["tokens"].max() < 1000
    np.testing.assert_array_equal(a["tokens"][:, 1:], a["labels"][:, :-1])


def test_uneven_shards_raise():
    with pytest.raises(ValueError, match="shards"):
        SyntheticLM(DataConfig(vocab=10, seq_len=4, global_batch=6,
                               num_shards=4)).batch(0)
