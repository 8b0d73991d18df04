"""The port's token data (``repro_torch.data.pipeline.BigramStream`` and
``TokenPipeline``) against the reference's (``repro.data.pipeline``):
the successor table, the probabilities and every sampled batch are
identical for the same seeds (NumPy on both sides), and the pipeline's
batches come out in the same order, as int32 tensors on the CPU here.
"""
import numpy as np
import pytest
import torch

from repro.data import pipeline as jpipe
from repro_torch.data import pipeline as tpipe


@pytest.mark.parametrize("vocab,seed", [(64, 0), (49152, 0), (512, 7)])
def test_bigram_stream_identical(vocab, seed):
    j, t = jpipe.BigramStream(vocab, seed), tpipe.BigramStream(vocab, seed)
    np.testing.assert_array_equal(t.succ, j.succ)
    np.testing.assert_array_equal(t.p, j.p)
    for step in (0, 1, 25):
        want = j.sample(np.random.default_rng(1000 + step), 4, 33)
        got = t.sample(np.random.default_rng(1000 + step), 4, 33)
        assert got.dtype == want.dtype == np.int32
        np.testing.assert_array_equal(got, want)


def test_bigram_stream_learnable_structure():
    """``tests/test_runtime.py``'s check: most transitions follow the
    successor table."""
    s = tpipe.BigramStream(64, seed=0)
    toks = s.sample(np.random.default_rng(0), 8, 100)
    assert toks.shape == (8, 101)
    assert toks.min() >= 0 and toks.max() < 64
    hits = sum(int(toks[b, t + 1] in s.succ[toks[b, t]])
               for b in range(8) for t in range(100))
    assert hits / 800 > 0.7


def test_token_pipeline_batches_identical():
    j = jpipe.TokenPipeline(vocab=32, batch=2, seq=8, seed=3, prefetch=2)
    t = tpipe.TokenPipeline(vocab=32, batch=2, seq=8, seed=3, prefetch=2,
                            device="cpu")
    try:
        for _ in range(4):
            want, got = next(j), next(t)
            assert set(got) == {"tokens", "labels"}
            for k in ("tokens", "labels"):
                assert isinstance(got[k], torch.Tensor)
                assert got[k].dtype == torch.int32
                assert got[k].device.type == "cpu"
                np.testing.assert_array_equal(got[k].numpy(), want[k])
    finally:
        j.close()
        t.close()
    t._thread.join(timeout=5)
    assert not t._thread.is_alive()


def test_token_pipeline_straggler_guard():
    """A consumer that finds no batch within ``skip_after`` makes one
    inline rather than stalling."""
    t = tpipe.TokenPipeline(vocab=32, batch=2, seq=8, prefetch=1,
                            skip_after=0.0, device="cpu")
    try:
        batches = [next(t) for _ in range(5)]
    finally:
        t.close()
    assert all(b["tokens"].shape == (2, 8) for b in batches)


def test_token_pipeline_shardings_of_none_keep_plain_tensors():
    """A key that ``shardings`` maps to ``None``, or lacks, stays a plain
    tensor, as ``jax.device_put(v, None)`` leaves an array (the mesh
    placement runs on gloo ranks in ``test_torch_distributed.py``)."""
    plain = tpipe.TokenPipeline(32, 2, 8, seed=5, device="cpu")
    placed = tpipe.TokenPipeline(32, 2, 8, seed=5, device="cpu",
                                 shardings={"tokens": None})
    try:
        for _ in range(3):
            want, got = next(plain), next(placed)
            for k in ("tokens", "labels"):
                assert type(got[k]) is torch.Tensor
                assert torch.equal(got[k], want[k])
    finally:
        plain.close()
        placed.close()


def test_token_pipeline_refuses_a_missing_card():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="device='cpu'"):
            tpipe.TokenPipeline(32, 2, 8)
