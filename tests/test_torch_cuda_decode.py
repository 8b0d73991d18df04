"""Prefill and one-token decode on the card against the same steps on the
CPU (``pytest -m cuda``), at smoke configs in float32: the same weights
on both, the card's caches made on the card (``init_caches(device=)``,
``lm_prefill``) and updated in place there. Each test skips itself when
no card is present, so every worker collects the same tests.

Tolerances: prefill logits at atol = rtol = 1e-4, ``pos`` exact, k/v
within one bf16 ulp of the CPU's (a float32 key summed in another order
can round to the other bf16 neighbour), and no tighter than 1e-5 of the
leaf's largest value (a key near 0 carries the float32 error of its
summands, many of its own ulps). The decode starts on both sides
from the card's prefilled cache. In a float32 config a decode step still
rounds to bf16 (the cache, the attention probabilities, its output and
``wo``, the reference's dtype flow), where one float32 last bit can move
a rounding to the other neighbour on one side: each step's logits are
held no farther from the CPU's than the CPU's decode is from its full
float32 forward over the same tokens (the whole bf16 path's effect)."""
import numpy as np
import pytest
import torch

from repro_torch.configs import get_smoke_config, scaled
from repro_torch.models import init_caches, lm_decode_step, lm_forward, \
    lm_prefill, lm_specs
from repro_torch.sharding.api import materialize, tree_map
from repro_torch.train.step import make_decode_step, make_prefill_step

pytestmark = pytest.mark.cuda

TOL, PREFILL, STEPS, MAX_SEQ = 1e-4, 20, 8, 32
FAMILY_TOL = {"zamba2-2.7b": 5e-4}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _setup(arch, **kw):
    cfg = scaled(get_smoke_config(arch), dtype="float32", **kw)
    cpu = materialize(lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    toks = torch.as_tensor(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, PREFILL + STEPS)))
    return cfg, cpu, toks


def _to(tree, dev):
    return tree_map(lambda t: t.to(dev), tree, is_leaf=torch.is_tensor)


def _leaves(caches):
    return [t for b in caches["blocks"] for _, t in sorted(b.items())]


@pytest.mark.parametrize("arch,int8", [
    ("smollm-135m", False), ("gemma3-12b", False),
    ("granite-moe-1b-a400m", False), ("mixtral-8x7b", False),
    ("smollm-135m", True)])
def test_prefill_and_decode_on_the_card_match_the_cpu(arch, int8):
    dev = _card()
    cfg, cpu, toks = _setup(arch, opt_kv_int8=int8)
    card = _to(cpu, dev)
    with torch.inference_mode():
        gc, gl = lm_prefill(cfg, card, {"tokens": toks[:, :PREFILL].to(dev)},
                            max_seq=MAX_SEQ)
        cc, cl = lm_prefill(cfg, cpu, {"tokens": toks[:, :PREFILL]},
                            max_seq=MAX_SEQ)
        assert all(t.device == dev for t in _leaves(gc))
        torch.testing.assert_close(gl.cpu(), cl, atol=TOL, rtol=TOL)
        for g, c in zip(_leaves(gc), _leaves(cc), strict=True):
            g = g.cpu()
            assert g.dtype == c.dtype and g.shape == c.shape
            if g.dtype == torch.bfloat16:
                c = c.float()
                ulp = torch.exp2(torch.floor(torch.log2(
                    c.abs().clamp_min(2.0 ** -126))) - 7)
                tol = ulp.clamp_min(1e-5 * float(c.abs().max()))
                d = (g.float() - c).abs()
                i = int((d - tol).argmax())
                assert (d <= tol).all(), (float(d.flatten()[i]),
                                          float(c.flatten()[i]))
            elif g.dtype == torch.int8:          # a rounding flips by one
                assert (g.int() - c.int()).abs().max() <= 1
            else:
                assert torch.equal(g, c)
        full = lm_forward(cfg, cpu, {"tokens": toks})[0]
        cc = _to(gc, "cpu")
        ptrs = [t.data_ptr() for t in _leaves(gc)]
        for pos in range(PREFILL, PREFILL + STEPS):
            t = toks[:, pos:pos + 1]
            out, got = lm_decode_step(cfg, card, gc, t.to(dev), pos)
            _, want = lm_decode_step(cfg, cpu, cc, t, pos)
            assert out is gc and [x.data_ptr() for x in _leaves(gc)] == ptrs
            bound = (want - full[:, pos]).abs().max()
            assert (got.cpu() - want).abs().max() <= bound
            for g, c in zip(gc["blocks"], cc["blocks"]):
                assert torch.equal(g["pos"].cpu(), c["pos"])


def test_init_caches_honours_the_device_and_steps_serve_greedy_tokens():
    """``init_caches(device=card)`` puts every leaf on the card; the step
    functions serve greedy (B, 1) int32 tokens there, the cache updated
    in place."""
    dev = _card()
    cfg, cpu, toks = _setup("gemma3-12b")
    empty = init_caches(cfg, 2, MAX_SEQ, device=dev)
    assert all(t.device == dev for t in _leaves(empty))
    assert [t.shape for t in _leaves(empty)] == [
        t.shape for t in _leaves(init_caches(cfg, 2, MAX_SEQ, device="cpu"))]
    card = _to(cpu, dev)
    with torch.inference_mode():
        caches, logits = make_prefill_step(cfg, MAX_SEQ)(
            card, {"tokens": toks[:, :PREFILL].to(dev)})
        decode = make_decode_step(cfg)
        tok = torch.argmax(logits, dim=-1).to(torch.int32)[:, None]
        for pos in range(PREFILL, PREFILL + STEPS):
            out, tok, logits = decode(card, caches, tok, pos)
            assert out is caches
            assert tok.device == dev and tok.dtype == torch.int32
            assert tok.shape == (2, 1) and torch.isfinite(logits).all()
        assert sorted(caches["blocks"][0]["pos"][0].tolist()) == list(
            range(PREFILL + STEPS - cfg.sliding_window, PREFILL + STEPS))


def _family_batch(cfg, dev, S):
    """Seeded tokens (2, S), and for an encoder-decoder config the stub
    audio embeddings (2, encoder_seq, d), on ``dev``."""
    rng = np.random.default_rng(2)
    b = {"tokens": torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, S)))}
    if cfg.is_encoder_decoder:
        b["audio_embed"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32)
    return {k: v.to(dev) for k, v in b.items()}


@pytest.mark.parametrize("arch", ["xlstm-125m", "zamba2-2.7b",
                                  "whisper-tiny"])
def test_recurrent_hybrid_and_encoder_decoder_decode_on_the_card(arch):
    """The recurrent (xlstm), hybrid (zamba2: Mamba2 + the shared block)
    and encoder-decoder (whisper) smoke configs in float32, card against
    CPU: the forward's logits within ``FAMILY_TOL`` (zamba2's Mamba2
    chunks subtract cumulative log decays of ~500, where one float32 last
    bit of ``dt`` moves outputs by ~1e-5 relative a layer); a prefill of
    16 tokens (one chunk) on the card; then 8 teacher-forced steps on
    both from the card's caches copied to the CPU, the card's caches
    updated in place (the same tensors), each step's logits no farther
    from the CPU's than the CPU's decode is from its full forward over
    the same tokens, or ``TOL`` where that is smaller (xlstm decodes in
    float32 throughout)."""
    dev = _card()
    cfg = scaled(get_smoke_config(arch), dtype="float32")
    cpu = materialize(lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    card = _to(cpu, dev)
    P = 16
    batch = _family_batch(cfg, "cpu", 32)       # two chunks of 16
    with torch.inference_mode():
        full = lm_forward(cfg, cpu, batch)[0]
        got = lm_forward(cfg, card, _to(batch, dev))[0].cpu()
        V = cfg.vocab_size
        tol = FAMILY_TOL.get(arch, TOL)
        torch.testing.assert_close(got[..., :V], full[..., :V], atol=tol,
                                   rtol=tol)
        pre = {**batch, "tokens": batch["tokens"][:, :P]}
        gc, _ = lm_prefill(cfg, card, _to(pre, dev), max_seq=MAX_SEQ)
        assert all(t.device == dev for t in _leaves(gc))
        cc = _to(gc, "cpu")
        ptrs = [t.data_ptr() for t in _leaves(gc)]
        before = [t.clone() for t in _leaves(gc)]
        toks = batch["tokens"]
        for pos in range(P, P + STEPS):
            t = toks[:, pos:pos + 1]
            out, got = lm_decode_step(cfg, card, gc, t.to(dev), pos)
            _, want = lm_decode_step(cfg, cpu, cc, t, pos)
            assert out is gc and [x.data_ptr() for x in _leaves(gc)] == ptrs
            bound = max(float((want - full[:, pos]).abs().max()), TOL)
            assert float((got.cpu() - want).abs().max()) <= bound
        assert all(not torch.equal(a, b) for a, b in zip(
            _leaves(gc), before) if a.dtype != torch.int32)
