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
    are (no copy), its dtype flag and the float32 kernel's split count
    with its scratch pointers (none when unsplit); one packing for both
    kernels."""
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
    assert (p.n_split, p.partials, p.tickets) == (1, None, None)
    part = torch.empty(64, dtype=torch.float32)
    tick = torch.zeros(8, dtype=torch.int32)
    p = tkernel.pack_params(q, k, v, out, causal=False, window=None,
                            scale=0.5, n_split=5,
                            partials=part.data_ptr(),
                            tickets=tick.data_ptr())
    assert (p.n_split, p.partials, p.tickets) == \
        (5, part.data_ptr(), tick.data_ptr())
    assert (p.causal, p.has_window, p.window) == (0, 0, 0)


def test_f32_alignment_check_takes_four_element_strides():
    """Float32 rows are copied 4 elements at a time: bsnh views, fresh
    tensors and a head stride of 68 pass; a base one float off a 16-byte
    boundary and strides that are no multiple of 4 elements raise."""
    B, S, H, d = 2, 48, 9, 64
    q = torch.zeros((B, S, H, d))
    tkernel.check_cp_async_alignment(q=q.transpose(1, 2),
                                     k=torch.zeros((B, H, S, d)))
    heads = torch.zeros((B, S, H, d + 4))[..., :d].transpose(1, 2)
    tkernel.check_cp_async_alignment(q=heads)          # 68 % 4 == 0
    with pytest.raises(ValueError, match="q's head stride 68 is not a "
                                         "multiple of 8"):   # bf16: 8
        tkernel.check_cp_async_alignment(q=torch.zeros(
            (B, S, H, d + 4), dtype=torch.bfloat16)[..., :d].transpose(1, 2))
    flat = torch.zeros(B * H * S * d + 4)
    with pytest.raises(ValueError, match="v's data pointer"):
        tkernel.check_cp_async_alignment(
            v=flat[1:1 + B * H * S * d].view(B, H, S, d))
    with pytest.raises(ValueError, match="k's seq stride 66 is not a "
                                         "multiple of 4"):
        tkernel.check_cp_async_alignment(
            k=torch.zeros((B, H, S, d + 2))[..., :d])
    with pytest.raises(ValueError, match="q's batch stride"):
        tkernel.check_cp_async_alignment(q=torch.as_strided(
            torch.zeros(2 * H * S * d + 2), (2, H, S, d),
            (H * S * d + 2, S * d, d, 1)))
    # one row of one head of one batch: no stride is stepped over
    tkernel.check_cp_async_alignment(
        q=torch.zeros((1, 1, 1, d + 2))[..., :d])


def _visible_tiles(Sq, Sk, block_q, block_k, qt, causal, window):
    """Brute force: the K tiles holding a key that some real query row of
    q tile ``qt`` sees."""
    rows = np.arange(qt * block_q, min(Sq, (qt + 1) * block_q))
    qpos = rows[:, None] + Sk - Sq
    kp = np.arange(Sk)[None, :]
    see = np.ones((len(rows), Sk), bool)
    if causal:
        see = kp <= qpos
        if window is not None:
            see &= qpos - kp < window
    return sorted({int(t) for t in np.nonzero(see.any(0))[0] // block_k})


PLAN_CASES = [
    # B, Hq, Sq, Sk, d, causal, window, resident
    (2, 9, 512, 2048, 64, True, None, 264),     # chip_smoke (c) tail
    (2, 9, 2048, 2048, 64, True, None, 264),    # (c) padded
    (4, 9, 2048, 2048, 64, True, None, 264),    # (a): a long grid
    (1, 16, 4096, 4096, 256, True, 1024, 132),  # (b): a long grid
    (2, 6, 1, 4096, 64, True, 300, 264),        # one query, windowed
    (1, 4, 200, 1000, 32, False, None, 264),    # bidirectional, ragged
    (1, 4, 200, 1000, 128, True, 50, 264),
    (1, 2, 256, 192, 64, True, None, 264),      # Sq > Sk: rows see nothing
    (3, 5, 64, 4096, 256, True, 4000, 132),
]


@pytest.mark.parametrize("case", PLAN_CASES)
def test_flash_plan_covers_every_visible_k_tile_once(case):
    """The float32 kernel's block map (``FlashPlan.block``) gives every
    (q tile, head, batch) its ``n_split`` splits, whose contiguous K-tile
    ranges, in split order, are exactly the K tiles its mask lets through;
    q tiles run heaviest (last) first."""
    B, Hq, Sq, Sk, d, causal, window, resident = case
    plan = tkernel.flash_plan(B, Hq, Sq, Sk, d, causal, window, resident)
    assert (plan.block_q, plan.block_k) == tkernel.f32_tiles(d)
    seen = {}
    order = []
    for x in range(plan.grid):
        qt, s, h, b = plan.block(x)
        assert 0 <= qt < plan.n_qtiles and 0 <= h < Hq and 0 <= b < B
        seen.setdefault((qt, h, b), []).append((s, plan.split_tiles(qt, s)))
        order.append(qt)
    assert len(seen) == plan.tiles == plan.n_qtiles * Hq * B
    assert order == sorted(order, reverse=True)
    for (qt, h, b), splits in seen.items():
        assert [s for s, _ in splits] == list(range(plan.n_split))
        tiles = [t for _, r in splits for t in r]
        assert tiles == list(plan.k_tiles(qt))
        assert tiles == _visible_tiles(Sq, Sk, plan.block_q, plan.block_k,
                                       qt, causal, window)
    if plan.n_split > 1:
        assert plan.partial_floats == \
            plan.grid * plan.block_q * (d + 2)


def test_flash_plan_splits_short_grids_only():
    """One block a q tile where the q tiles x heads x batch fill
    ``FLASH_SPLIT_WAVES`` resident grids; otherwise enough splits for
    that, at most ``MAX_SPLIT`` and at most the K tiles a q tile sees."""
    plan = tkernel.flash_plan
    assert plan(4, 9, 2048, 2048, 64, True, None, 264).n_split == 1
    assert plan(1, 16, 4096, 4096, 256, True, 1024, 132).n_split == 1
    assert plan(4, 9, 2048, 2048, 64, True, None, 264).partial_floats == 0
    tail = plan(2, 9, 512, 2048, 64, True, None, 264)
    assert tail.tiles == 72 and tail.n_split == -(-2 * 264 // 72)
    assert plan(1, 1, 1, 4096, 64, True, None, 264).n_split == \
        tkernel.MAX_SPLIT
    assert plan(1, 1, 1, 128, 64, True, None, 264).n_split == 2   # 2 tiles
    assert plan(1, 1, 1, 0, 64, True, None, 264).n_split == 1     # no keys
    with pytest.raises(ValueError):
        plan(1, 1, 1, 64, 48, True, None, 264)


def test_f32_tiles_mirror_the_kernel_source():
    """``F32_TILES`` is flash.cu's ``Tiles<HD>`` table, entry for entry:
    the wrapper sizes the split scratch from it."""
    import re
    from pathlib import Path
    src = (Path(tkernel.__file__).parent / "csrc" / "flash.cu").read_text()
    table = {int(m[0]): tuple(int(x) for x in m[1:]) for m in re.findall(
        r"struct Tiles<(\d+)> : TileShape<(\d+), (\d+), (\d+), (\d+)>",
        src)}
    assert table == tkernel.F32_TILES
    assert sorted(table) == list(tkernel.HEAD_DIMS)
    assert "constexpr int THREADS = 256;" in src
    assert tkernel.F32_THREADS == 256


F32_PTXAS = """== flash_attention/csrc/flash.cu
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112flash_kernelILi64EEEv11FlashParamsPKfS3_S3_Pf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112flash_kernelILi64EEEv11FlashParamsPKfS3_S3_Pf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 122 registers, used 1 barriers, 4 bytes smem, 536 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN12_GLOBAL__N_112flash_kernelILi256EEEv11FlashParamsPKfS3_S3_Pf' for 'sm_90a'
ptxas info    : Function properties for _ZN12_GLOBAL__N_112flash_kernelILi256EEEv11FlashParamsPKfS3_S3_Pf
    8 bytes stack frame, 4 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 4 bytes smem, 536 bytes cmem[0]
ptxas info    : Compiling entry function '_ZN9flash_mma14flash_mma_bf16ILi64ELi64ELi3EEEv11FlashParamsPK13__nv_bfloat16S4_S4_PS2_' for 'sm_90a'
ptxas info    : Function properties for _ZN9flash_mma14flash_mma_bf16ILi64ELi64ELi3EEEv11FlashParamsPK13__nv_bfloat16S4_S4_PS2_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 107 registers, used 1 barriers, 536 bytes cmem[0]
"""


def test_f32_kernel_usage_reads_the_ptxas_report():
    """The float32 kernel's registers and spills per head dim, with its
    tiles; the bf16 kernel's entries are left to ``mma_kernel_usage``."""
    assert tkernel.f32_kernel_usage(F32_PTXAS) == {
        64: dict(block_q=128, block_k=64, registers=122, spill_stores=0,
                 spill_loads=0),
        256: dict(block_q=64, block_k=64, registers=255, spill_stores=4,
                  spill_loads=8)}
    assert list(tkernel.mma_kernel_usage(F32_PTXAS)) == [64]
    assert tkernel.f32_kernel_usage("") == {}
