"""The port's LM token pipeline (``repro_torch.data.tokens``) against the
reference's ``repro.data.tokens``: every batch bit for bit, by step, shard
and seed, and the global batch as the shards' concatenation."""
import numpy as np
import pytest

from repro.data import tokens as ref_tokens
from repro_torch.data import TokenPipeline, TokenPipelineConfig
from repro_torch.data import tokens

CONFIGS = [
    dict(vocab_size=512, global_batch=4, seq_len=64),
    dict(vocab_size=49_152, global_batch=8, seq_len=128, shards=4),
    dict(vocab_size=100, global_batch=6, seq_len=7, shards=3, seed=3),
]


def _pair(kw):
    return (TokenPipeline(TokenPipelineConfig(**kw)),
            ref_tokens.TokenPipeline(ref_tokens.TokenPipelineConfig(**kw)))


@pytest.mark.parametrize("kw", CONFIGS, ids=["one_shard", "four_shards", "seed3"])
def test_batches_equal_reference_bit_for_bit(kw):
    mine, ref = _pair(kw)
    for step in (0, 1, 17, 1000):
        for shard in range(kw.get("shards", 1)):
            got, want = mine.batch(step, shard), ref.batch(step, shard)
            assert got.keys() == want.keys() == {"tokens", "labels"}
            for k in got:
                assert got[k].dtype == want[k].dtype == np.int32
                np.testing.assert_array_equal(got[k], want[k])
        got, want = mine.global_batch(step), ref.global_batch(step)
        for k in got:
            assert got[k].shape == (kw["global_batch"], kw["seq_len"])
            np.testing.assert_array_equal(got[k], want[k])
        assert (got["tokens"] < kw["vocab_size"]).all() and (got["tokens"] >= 0).all()
        np.testing.assert_array_equal(got["tokens"][:, 1:], got["labels"][:, :-1])


def test_steps_and_shards_differ():
    mine, _ = _pair(CONFIGS[1])
    a, b, c = mine.batch(0, 0)["tokens"], mine.batch(1, 0)["tokens"], mine.batch(0, 1)["tokens"]
    assert not np.array_equal(a, b) and not np.array_equal(a, c)


def test_batch_must_split_into_shards():
    kw = dict(vocab_size=10, global_batch=5, seq_len=4, shards=2)
    with pytest.raises(ValueError, match="multiple"):
        tokens.TokenPipeline(TokenPipelineConfig(**kw))
    with pytest.raises(AssertionError):
        ref_tokens.TokenPipeline(ref_tokens.TokenPipelineConfig(**kw))
