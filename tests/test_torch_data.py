"""The port's data pipeline against the reference: batches bitwise for
several (seed, step, process index, process count), embeddings and
enc-dec streams included; the reference's own determinism, sharding and
cursor tests (``tests/test_checkpoint_fault_data.py``) on the port; the
process index and count from ``torch.distributed``."""
import numpy as np
import pytest

from repro.data.pipeline import DataConfig as RDataConfig
from repro.data.pipeline import SyntheticTokenSource as RSource
from repro_torch.data import pipeline
from repro_torch.data.pipeline import DataConfig, SyntheticTokenSource


@pytest.mark.parametrize("seed,pc,embed_dim,encdec", [
    (0, 1, 0, False), (3, 4, 0, False), (7, 2, 16, False),
    (11, 2, 16, True)])
def test_batches_bitwise_the_reference(seed, pc, embed_dim, encdec):
    kw = dict(global_batch=8, seq_len=24, vocab=1000, seed=seed,
              embed_dim=embed_dim, encdec=encdec)
    for pi in range(pc):
        src = SyntheticTokenSource(DataConfig(**kw), process_index=pi,
                                   process_count=pc)
        ref = RSource(RDataConfig(**kw), process_index=pi, process_count=pc)
        for step in (0, 1, 5, 123):
            a, b = src(step), ref(step)
            assert sorted(a) == sorted(b)
            for k in a:
                assert a[k].dtype == b[k].dtype and a[k].shape == b[k].shape
                np.testing.assert_array_equal(a[k].view(np.uint8),
                                              b[k].view(np.uint8))
    assert src.checkpoint_state(9) == ref.checkpoint_state(9)


def test_data_deterministic():
    cfg = DataConfig(global_batch=8, seq_len=16, vocab=100, seed=3)
    s1 = SyntheticTokenSource(cfg, process_index=0, process_count=1)
    s2 = SyntheticTokenSource(cfg, process_index=0, process_count=1)
    for i in (0, 5, 11):
        a, b = s1(i), s2(i)
        np.testing.assert_array_equal(a["tokens"], b["tokens"])
        np.testing.assert_array_equal(a["labels"], b["labels"])


def test_data_per_host_sharding_partitions_batch():
    cfg = DataConfig(global_batch=8, seq_len=16, vocab=100, seed=3)
    shards = [SyntheticTokenSource(cfg, process_index=p, process_count=4)(2)
              for p in range(4)]
    assert all(s["tokens"].shape == (2, 16) for s in shards)
    assert not np.array_equal(shards[0]["tokens"], shards[1]["tokens"])
    with pytest.raises(ValueError, match="divide"):
        SyntheticTokenSource(cfg, process_index=0, process_count=3)


def test_data_resume_cursor():
    cfg = DataConfig(global_batch=4, seq_len=8, vocab=64)
    src = SyntheticTokenSource(cfg, process_index=0, process_count=1)
    state = src.checkpoint_state(17)
    assert SyntheticTokenSource.resume_step(state) == 17
    np.testing.assert_array_equal(src(17)["tokens"], src(17)["tokens"])


def test_process_defaults_follow_torch_distributed(monkeypatch):
    """0 of 1 without a process group; the group's rank and world size
    with one (the reference reads ``jax.process_index()``)."""
    cfg = DataConfig(global_batch=8, seq_len=4, vocab=50)
    src = SyntheticTokenSource(cfg)
    assert (src.pi, src.pc, src.local_batch) == (0, 1, 8)
    monkeypatch.setattr(pipeline.dist, "is_initialized", lambda: True)
    monkeypatch.setattr(pipeline.dist, "get_rank", lambda: 3)
    monkeypatch.setattr(pipeline.dist, "get_world_size", lambda: 4)
    src = SyntheticTokenSource(cfg)
    assert (src.pi, src.pc, src.local_batch) == (3, 4, 2)
    ref = RSource(RDataConfig(global_batch=8, seq_len=4, vocab=50),
                  process_index=3, process_count=4)
    np.testing.assert_array_equal(src(6)["tokens"], ref(6)["tokens"])
