"""The port's flash attention entry points (``flash_attention``,
``flash_attention_bsnh``) on CPU tensors against the reference's Pallas
kernel (interpret mode) and its oracle ``attention_ref``: the same
numpy-seeded inputs, at the reference's own tolerance (atol = rtol =
2e-6 for float32, 2e-2 for bfloat16; ``tests/test_kernels_flash.py``).

A CPU tensor takes the kernel's plain version, so these hold the
semantics the CUDA kernel is held to on the card
(``tests/test_torch_cuda_kernels.py``). One case pins a fault of the
reference kernel that the port does not copy: with ``Sq > Sk`` the rows
before key 0 see no key; the oracle gives 0, the Pallas kernel the mean
of a value block."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention.kernel import flash_attention as jflash
from repro.kernels.flash_attention.ops import flash_attention_bsnh as jbsnh
from repro.kernels.flash_attention.ref import attention_ref as jref
from repro_torch.kernels.flash_attention import kernel as tkernel
from repro_torch.kernels.flash_attention.kernel import flash_attention
from repro_torch.kernels.flash_attention.ops import flash_attention_bsnh
from repro_torch.kernels.flash_attention.ref import attention_ref

CASES = [
    # B, Hq, Hkv, Sq, Sk, d, causal, window  (tests/test_kernels_flash.py)
    (2, 4, 2, 256, 256, 64, True, None),
    (1, 4, 4, 128, 256, 32, True, None),        # q at cache tail
    (1, 8, 2, 256, 256, 64, True, 128),         # sliding window
    (2, 2, 2, 128, 128, 64, False, None),       # bidirectional
    (1, 2, 1, 512, 512, 128, True, 64),
    (1, 16, 4, 128, 128, 64, True, None),       # wide GQA group
]
DTYPES = {"float32": (jnp.float32, torch.float32, 2e-6),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}


def _inputs(rng, qshape, kshape, dtype):
    """The same seeded values as a JAX and a torch tensor of ``dtype``
    (bf16 rounded once, in JAX, and carried bit for bit)."""
    jd, td, _ = DTYPES[dtype]
    out = []
    for shape in (qshape, kshape, kshape):
        j = jnp.asarray(rng.standard_normal(shape), jd)
        t = torch.from_numpy(np.array(j.astype(jnp.float32))).to(td)
        out.append((j, t))
    return out


def _np(x):
    return np.asarray(x.float().numpy() if torch.is_tensor(x)
                      else x.astype(jnp.float32))


@pytest.mark.parametrize("case", CASES)
@pytest.mark.parametrize("dtype", list(DTYPES))
def test_port_matches_pallas_and_oracle(case, dtype, rng):
    B, Hq, Hkv, Sq, Sk, d, causal, window = case
    (jq, tq), (jk, tk), (jv, tv) = _inputs(rng, (B, Hq, Sq, d),
                                           (B, Hkv, Sk, d), dtype)
    tol = DTYPES[dtype][2]
    before = tkernel.flash_attention.launches
    got = flash_attention(tq, tk, tv, causal=causal, window=window)
    assert tkernel.flash_attention.launches == before   # CPU: plain path
    assert got.dtype == tq.dtype and tuple(got.shape) == (B, Hq, Sq, d)
    pallas = jflash(jq, jk, jv, causal=causal, window=window, interpret=True)
    oracle = jref(jq, jk, jv, causal=causal, window=window)
    np.testing.assert_allclose(_np(got), _np(pallas), atol=tol, rtol=tol)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)
    np.testing.assert_allclose(
        _np(attention_ref(tq, tk, tv, causal=causal, window=window)),
        _np(got), atol=0, rtol=0)


@pytest.mark.parametrize("bq,bk", [(64, 64), (128, 64), (64, 128)])
def test_block_shapes(bq, bk, rng):
    (jq, tq), (jk, tk), (jv, tv) = _inputs(rng, (1, 2, 256, 64),
                                           (1, 2, 256, 64), "float32")
    got = flash_attention(tq, tk, tv, causal=True, block_q=bq, block_k=bk)
    want = jflash(jq, jk, jv, causal=True, block_q=bq, block_k=bk,
                  interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=2e-6, rtol=2e-6)


def test_reference_asserts_are_kept():
    q = torch.zeros((1, 2, 100, 64))
    with pytest.raises(AssertionError):
        flash_attention(q, q, q)                   # 100 % 128 != 0
    q, kv = torch.zeros((1, 3, 64, 64)), torch.zeros((1, 2, 64, 64))
    with pytest.raises(AssertionError):
        flash_attention(q, kv, kv, block_q=64, block_k=64)   # 3 % 2 != 0


@pytest.mark.parametrize("dtype", list(DTYPES))
def test_bsnh_wrapper_with_padding(dtype, rng):
    """Model layout + non-block-multiple sequence (S=200 pads to 256)."""
    B, S, Hq, Hkv, d = 2, 200, 4, 2, 64
    (jq, tq), (jk, tk), (jv, tv) = _inputs(rng, (B, S, Hq, d),
                                           (B, S, Hkv, d), dtype)
    tol = DTYPES[dtype][2]
    got = flash_attention_bsnh(tq, tk, tv, causal=True)
    assert tuple(got.shape) == (B, S, Hq, d) and got.dtype == tq.dtype
    want = jbsnh(jq, jk, jv, causal=True, interpret=True)
    np.testing.assert_allclose(_np(got), _np(want), atol=tol, rtol=tol)
    oracle = jref(jq.swapaxes(1, 2), jk.swapaxes(1, 2), jv.swapaxes(1, 2),
                  causal=True).swapaxes(1, 2)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=tol, rtol=tol)


def test_bsnh_padding_asserts():
    q = torch.zeros((1, 200, 2, 64))
    k = torch.zeros((1, 256, 2, 64))
    with pytest.raises(AssertionError):
        flash_attention_bsnh(q, k, k)              # padding with Sq != Sk
    with pytest.raises(AssertionError):
        flash_attention_bsnh(q, q, q, causal=False)   # pad keys visible


def test_rows_before_the_first_key_give_zero(rng):
    """``Sq > Sk``, causal: q rows 0..63 sit before key 0 and see no key.
    The port gives the oracle's 0 there and matches it everywhere; the
    reference's Pallas kernel (``block_q=128, block_k=64``) gives those
    rows the mean of v[0:64] instead (its masked rows of a live K block
    take p = exp(0) = 1), which this test pins as a known reference
    fault."""
    B, H, Sq, Sk, d = 1, 2, 256, 192, 64
    (jq, tq), (jk, tk), (jv, tv) = _inputs(rng, (B, H, Sq, d),
                                           (B, H, Sk, d), "float32")
    got = flash_attention(tq, tk, tv, causal=True, block_q=128, block_k=64)
    oracle = jref(jq, jk, jv, causal=True)
    np.testing.assert_allclose(_np(got), _np(oracle), atol=2e-6, rtol=2e-6)
    assert not _np(got)[:, :, :Sq - Sk].any()
    pallas = _np(jflash(jq, jk, jv, causal=True, block_q=128, block_k=64,
                        interpret=True))
    gap = np.abs(pallas[:, :, :Sq - Sk] - _np(oracle)[:, :, :Sq - Sk])
    assert gap.max() > 0.1
    mean_v = _np(jv)[:, :, :64].mean(axis=2, keepdims=True)
    np.testing.assert_allclose(pallas[:, :, :Sq - Sk],
                               np.broadcast_to(mean_v, (B, H, Sq - Sk, d)),
                               atol=1e-5)
    # past row 64 the reference kernel agrees with its oracle
    np.testing.assert_allclose(pallas[:, :, Sq - Sk:],
                               _np(oracle)[:, :, Sq - Sk:], atol=2e-6,
                               rtol=2e-6)


def test_work_and_traffic_counts():
    """The bound's inputs: visible pairs counted from the mask."""
    for Sq, Sk, causal, window in [(256, 256, True, None),
                                   (128, 256, True, None),
                                   (256, 256, True, 64), (256, 192, True, 16),
                                   (64, 64, False, None)]:
        mask = np.ones((Sq, Sk), bool)
        if causal:
            qp = np.arange(Sq)[:, None] + Sk - Sq
            kp = np.arange(Sk)[None, :]
            mask = kp <= qp
            if window is not None:
                mask &= (qp - kp) < window
        assert tkernel.visible_pairs(Sq, Sk, causal, window) == mask.sum()
    assert tkernel.attention_ops(2, 4, 8, 8, 16, causal=False) == \
        4 * 2 * 4 * 16 * 64
    assert tkernel.attention_bytes(1, 4, 2, 8, 16, 32, 2) == \
        (2 * 4 * 8 + 2 * 2 * 16) * 32 * 2


@pytest.mark.parametrize("d", tkernel.HEAD_DIMS)
def test_bf16_alignment_check_passes_bsnh_views(d):
    """The model layout's head-major views (strides S*H*d, d, H*d) and the
    padded path's fresh tensors meet the bf16 kernel's 16-byte cp.async
    rule, so ``flash_attention_bsnh`` never trips it."""
    B, S, Hq, Hkv = 2, 48, 9, 3
    q = torch.zeros((B, S, Hq, d), dtype=torch.bfloat16)
    kv = torch.zeros((B, S, Hkv, d), dtype=torch.bfloat16)
    tkernel.check_cp_async_alignment(q=q.transpose(1, 2),
                                     k=kv.transpose(1, 2),
                                     v=kv.transpose(1, 2))
    tkernel.check_cp_async_alignment(
        q=torch.zeros((B, Hq, 64, d), dtype=torch.bfloat16))
    # one query row: its seq stride is never stepped over
    tkernel.check_cp_async_alignment(
        q=torch.zeros((B, 1, Hq, d + 8), dtype=torch.bfloat16)
        [..., :d].transpose(1, 2))


def test_bf16_alignment_check_rejects_offset_and_odd_strides():
    B, H, S, d = 1, 2, 64, 64
    flat = torch.zeros(B * H * S * d + 8, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="k's data pointer"):
        tkernel.check_cp_async_alignment(
            q=flat[:B * H * S * d].view(B, H, S, d),
            k=flat[1:1 + B * H * S * d].view(B, H, S, d))
    odd = torch.zeros((B, H, S, d + 1), dtype=torch.bfloat16)[..., :d]
    with pytest.raises(ValueError, match="v's seq stride 65"):
        tkernel.check_cp_async_alignment(v=odd)
    heads = torch.zeros((B, S, H, d + 4), dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q's head stride 68"):
        tkernel.check_cp_async_alignment(q=heads[..., :d].transpose(1, 2))
    batch = torch.zeros(2 * H * S * d + 4, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="q's batch stride"):
        tkernel.check_cp_async_alignment(q=torch.as_strided(
            batch, (2, H, S, d), (H * S * d + 4, S * d, d, 1)))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_params_carry_the_views_strides(dtype):
    """The wrapper hands the kernel every view's element strides as they
    are (no copy) and its dtype flag; one packing for both kernels."""
    B, S, Hq, Hkv, d = 2, 128, 9, 3, 64
    q = torch.zeros((B, S, Hq, d), dtype=dtype).transpose(1, 2)
    k = torch.zeros((B, S, Hkv, d), dtype=dtype).transpose(1, 2)
    v = torch.zeros((B, Hkv, S, d), dtype=dtype)
    out = torch.empty((B, Hq, S, d), dtype=dtype)
    p = tkernel.pack_params(q, k, v, out, causal=True, window=16,
                            scale=0.125)
    assert (p.B, p.Hq, p.Hkv, p.Sq, p.Sk, p.d) == (B, Hq, Hkv, S, S, d)
    assert (p.causal, p.has_window, p.window, p.scale) == (1, 1, 16, 0.125)
    assert p.bf16 == int(dtype == torch.bfloat16)
    for name, t in (("q", q), ("k", k), ("v", v), ("o", out)):
        assert tuple(getattr(p, f"{name}_s{a}") for a in "bhs") == \
            t.stride()[:3]
    assert (p.q_sb, p.q_sh, p.q_ss) == (S * Hq * d, d, Hq * d)
