"""One training step on the card against the same step on the CPU
(``pytest -m cuda``), for the ten smoke configs: the same weights on both
(drawn on the CPU and copied), the same seeded batch, ``make_train_step``
with AdamW. Each test skips itself when no card is present, so every
worker collects the same tests.

Two float32 runs that sum in other orders drift apart through the layers
by more than any fixed bound (gemma3's smoke config: grad_norm 1.3e-4
apart, card vs CPU, NVIDIA H100), so both are held to a float64 step on
the CPU, as ``chip_smoke.py``'s lm phase holds logits: the card's loss,
grad_norm and every AdamW ``m`` and ``v`` leaf no farther from float64
than ``SLACK`` times the CPU's float32 step (or ``FLOOR`` of the leaf's
largest value). ``lr``, ``tokens`` and ``step`` are exact. AdamW moves
every entry by about lr, so an entry whose gradient is at the rounding
level may move either way: the card's new parameters are held to AdamW's
update recomputed on the CPU from the card's own ``m`` and ``v``, within
1e-6 of the leaf's largest value. The MoE configs dispatch with
``index_add_``, whose float sums on the card are atomic and not
bit-stable from run to run: they are held by the same bounds.
"""
import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_smoke_config, scaled
from repro_torch.models import lm_specs
from repro_torch.sharding.api import materialize, tree_leaves, tree_map
from repro_torch.train.optimizer import AdamW, warmup_cosine
from repro_torch.train.step import make_train_step

pytestmark = pytest.mark.cuda

SLACK, FLOOR, UPDATE_TOL = 4.0, 1e-5, 1e-6


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", torch.cuda.current_device())


def _on(tree, d, dtype=None):
    return tree_map(lambda t: t.to(d, dtype) if dtype and t.is_floating_point()
                    else t.to(d), tree, is_leaf=torch.is_tensor)


def _dist(x, ref):
    ref = ref.double()
    return float((x.cpu().double() - ref).abs().max()) / max(
        float(ref.abs().max()), 1e-30)


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_train_step_on_the_card_matches_the_cpu(arch):
    dev = _card()
    torch.backends.cuda.matmul.allow_tf32 = False    # float32 is float32
    cfg = scaled(get_smoke_config(arch), dtype="float32")
    cpu = materialize(lm_specs(cfg), torch.Generator().manual_seed(0), "cpu")
    rng = np.random.default_rng(1)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, (2, 33)))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}
    if cfg.is_encoder_decoder:
        batch["audio_embed"] = torch.as_tensor(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model)), dtype=torch.float32)
    opt = AdamW(lr=warmup_cosine(1e-3, 2, 10))
    card = _on(cpu, dev)
    p_g, s_g, m_g = make_train_step(cfg, opt)(card, opt.init(card),
                                              _on(batch, dev))
    _, s_c, m_c = make_train_step(cfg, opt)(cpu, opt.init(cpu), batch)
    p64 = _on(cpu, "cpu", torch.float64)
    _, s_x, m_x = make_train_step(scaled(cfg, dtype="float64"), opt)(
        p64, opt.init(p64), batch)
    assert all(t.device == dev for t in tree_leaves((p_g, s_g)))
    for k in ("lr", "tokens"):
        assert float(m_g[k]) == float(m_c[k])
    assert int(s_g["step"]) == int(s_c["step"]) == 1
    pairs = [(m_g[k], m_c[k], m_x[k]) for k in ("loss", "aux_loss",
                                                "grad_norm")
             if float(m_x[k]) != 0.0]
    for k in ("m", "v"):
        pairs += list(zip(tree_leaves(s_g[k]), tree_leaves(s_c[k]),
                          tree_leaves(s_x[k]), strict=True))
    for g, c, x in pairs:
        assert _dist(g, x) <= max(SLACK * _dist(c, x), FLOOR), (
            _dist(g, x), _dist(c, x))
    # the update on the card is AdamW's, from the card's own moments
    step = torch.tensor(1, dtype=torch.int32)
    sf = step.float()
    bc1 = 1 - torch.pow(torch.tensor(opt.b1), sf)
    bc2 = 1 - torch.pow(torch.tensor(opt.b2), sf)
    lr = opt.lr(step)
    for pg, p, m, v in zip(tree_leaves(p_g), tree_leaves(cpu),
                           tree_leaves(s_g["m"]), tree_leaves(s_g["v"]),
                           strict=True):
        want = p - lr * ((m.cpu() / bc1) / (torch.sqrt(v.cpu() / bc2)
                                            + opt.eps)
                         + opt.weight_decay * p)
        assert _dist(pg, want) <= UPDATE_TOL
