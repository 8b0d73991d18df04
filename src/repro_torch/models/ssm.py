"""Recurrent sequence mixers: Mamba2 (SSD), xLSTM's mLSTM and sLSTM — the
port of ``src/repro/models/ssm.py``, function by function, for
inference and training.

A full sequence (``*_train``) uses the chunk-parallel forms: quadratic
within a chunk of ``Q = min(cfg.ssm_chunk, L)`` tokens, and a Python loop
across the ``L / Q`` chunks carrying only the state. One token
(``*_step``) uses the exact recurrences. The sLSTM has no chunked form:
``slstm_train`` is a loop over time, its cell in float32 whatever
``cfg.dtype`` is; the dry run records one of its steps and counts it L
times (``_time_loop``).

As in the reference: the mLSTM chunked form has no stabilizer (it returns
``m = 0``) while its step is stabilized; the denominators are
``max(|den|, 1)`` chunked and ``max(|den|, exp(-m))`` a step; masks are
set inside the exponent (-1e30 before ``exp``), never after it. The
Mamba2 depthwise conv runs on the x-path only, in the activation dtype
over a sequence and in float32 a step, so chunked and step outputs differ
in bf16 by more than rounding (the reference's own bound).

Gates and states are float32 whatever ``cfg.dtype`` is, as in the
reference — float64 in a float64 config, which the reference has no use
for and the port's card checks use as their exact yardstick (``_f32``).

With ``cfg.opt_chunk_remat``, while grad is enabled, each chunk of the
Mamba2 and mLSTM chunked forms runs under ``torch.utils.checkpoint``, as
the reference's scan body runs under ``jax.checkpoint``: its O(Q^2)
intermediates are recomputed in the backward instead of saved (memory,
not values). A step returns a new state dict; the block layer copies it
into the caller's cache.
"""
from __future__ import annotations

import functools

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from repro_torch.models.common import remat, rmsnorm, silu
from repro_torch.sharding.api import ParamSpec, constrain, head_local, \
    is_dtensor

_MASKED = -1e30         # the reference's mask value, inside the exponent


def softplus(x):
    """``jax.nn.softplus``, which is ``logaddexp(x, 0)``: max(x, 0) +
    log1p(exp(-|x|)). ``F.softplus`` returns x above 20 instead (9.5e-7
    from the reference there); this form is within one float32 ulp of it
    on 200k values in [-40, 40] (measured on the CPU)."""
    return torch.clamp_min(x, 0.0) + torch.log1p(torch.exp(-x.abs()))


def log_sigmoid(x):
    """``jax.nn.log_sigmoid``: -softplus(-x) (within one float32 ulp of
    the reference, as ``softplus``)."""
    return -softplus(-x)


def _f32(t):
    """``t`` in float32 (the reference's ``.astype(jnp.float32)``), or in
    float64 if it is float64 already."""
    return t.double() if t.dtype == torch.float64 else t.float()


def _mm(x, w):
    """x (..., d) @ w (d, f), w cast to x's dtype: the reference's
    ``einsum("bld,df->blf", x, w.astype(x.dtype))``."""
    return torch.matmul(x, w.to(x.dtype))


def _cumsum(x, dim):
    """Cumulative sum accumulated in float64, rounded once to x's dtype.
    The cumulative log decays it makes reach ~1e3 in magnitude at full
    width, and ``exp(la_i - la_j)`` subtracts two of them: torch's CPU
    cumsum accumulates in float64 already, its CUDA one in float32, so
    this keeps the card's rounding the CPU's."""
    return torch.cumsum(x, dim=dim, dtype=torch.float64).to(x.dtype)


def _chunk_mask(Q: int, device) -> torch.Tensor:
    """(1, Q, Q, 1) lower triangle (j <= i)."""
    return torch.tril(torch.ones((Q, Q), dtype=torch.bool,
                                 device=device))[None, :, :, None]


def _chunks(cfg, L: int) -> int:
    """The chunk length ``min(cfg.ssm_chunk, L)``; L must be a multiple of
    it (the reference asserts this)."""
    Q = min(cfg.ssm_chunk, L)
    if L % Q:
        raise ValueError(f"{cfg.name}: a sequence of {L} tokens is not a "
                         f"multiple of the SSM chunk {Q} (ssm_chunk "
                         f"{cfg.ssm_chunk}): give fewer than {cfg.ssm_chunk} "
                         "tokens or a multiple of it")
    return Q


# ---------------------------------------------------------------------------
# Mamba2 (SSD)
# ---------------------------------------------------------------------------

def mamba2_specs(cfg) -> dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    N = cfg.ssm_state
    H = d_in // cfg.ssm_head_dim
    return {
        "wz": ParamSpec((d, d_in), ("embed", "mlp")),
        "wx": ParamSpec((d, d_in), ("embed", "mlp")),
        "wB": ParamSpec((d, N), ("embed", "state")),
        "wC": ParamSpec((d, N), ("embed", "state")),
        "wdt": ParamSpec((d, H), ("embed", "heads")),
        "dt_bias": ParamSpec((H,), ("heads",), init="zeros"),
        "A_log": ParamSpec((H,), ("heads",), init="neg_ssm_a"),
        "D": ParamSpec((H,), ("heads",), init="ones"),
        "conv_w": ParamSpec((4, d_in), ("dconv", "mlp"), scale=0.5),
        "norm": ParamSpec((d_in,), ("mlp",), init="ones"),
        "wo": ParamSpec((d_in, d), ("mlp", "embed")),
    }


# each Mamba2 weight split along its head (or d_in) dim by the
# reference's specs ("heads", "mlp"): that dim
_HEAD_DIMS = {"wz": 1, "wx": 1, "wdt": 1, "dt_bias": 0, "A_log": 0, "D": 0,
              "conv_w": 1, "norm": 0, "wo": 0}
# ``head_local`` roles of the per-rank functions' common arguments: xh, z,
# dt split over heads; B and C whole; conv_w, A_log and D weights
_MIX_IN = (("heads", 2), ("heads", 2), ("heads", 2), ("whole", 0),
           ("whole", 0), ("weight", 1), ("weight", 0), ("weight", 0))


def mamba2_head_split(params, cfg, x):
    """The mesh dim over which a Mamba2 mixer runs split over its heads,
    as the reference's GSPMD runs it: the one mesh dim that splits each
    weight of ``_HEAD_DIMS`` along that dim, where H is a multiple of
    its size M (so ``d_in / M`` is whole heads), and ``x`` whole on it. None on plain tensors and elsewhere (the block then
    runs the mixer under ``batch_local``)."""
    if not is_dtensor(x) or not all(is_dtensor(params[n])
                                    for n in _HEAD_DIMS):
        return None
    from torch.distributed.tensor import Shard
    mesh = x.device_mesh
    split = [[params[n].placements[i] == Shard(d)
              for n, d in _HEAD_DIMS.items()] for i in range(mesh.ndim)]
    dims = [i for i, s in enumerate(split) if all(s)]
    if len(dims) != 1 or sum(map(any, split)) != 1:
        return None
    (i,) = dims
    H = cfg.ssm_expand * cfg.d_model // cfg.ssm_head_dim
    if H % mesh.size(i) or not x.placements[i].is_replicate():
        return None
    return i


def _mamba2_inputs(params, cfg, x):
    """Project x: (B,L,d) -> z, xh (B,L,d_in) in x's dtype, B/C (B,L,N)
    and dt (B,L,H) in float32."""
    d_in = cfg.ssm_expand * cfg.d_model
    P = cfg.ssm_head_dim
    H = d_in // P
    z = _mm(x, params["wz"])
    xh = _mm(x, params["wx"])
    Bm = _f32(_mm(x, params["wB"]))
    Cm = _f32(_mm(x, params["wC"]))
    dt = softplus(_f32(_mm(x, params["wdt"])) + params["dt_bias"])
    return z, xh, Bm, Cm, dt, H, P


def _causal_conv(xh, w):
    """Depthwise causal conv, width 4, as four shifted multiply-adds in
    xh's dtype (not ``F.conv1d``: cuDNN would run float32 in TF32).
    xh: (B,L,F); w: (4,F)."""
    L = xh.shape[1]
    pad = torch.nn.functional.pad(xh, (0, 0, 3, 0))
    out = pad[:, 0:L] * w[0]
    for i in range(1, 4):
        out = out + pad[:, i:i + L] * w[i]
    return silu(out)


def _ssd_chunk(state, xb, Bq, Cq, la, tri):
    """One SSD chunk: (state after it, its output (B,Q,H,P))."""
    la_last = la[:, -1]                                          # (B,H)
    # inter: y_i = exp(la_i) * C_i . S_prev
    y_inter = torch.einsum("bqn,bhpn->bqhp", Cq, state) \
        * torch.exp(la)[..., None]
    # intra: y_i = sum_{j<=i} (C_i.B_j) exp(la_i - la_j) xbar_j
    G = torch.einsum("bin,bjn->bij", Cq, Bq)                     # (B,Q,Q)
    ldiff = torch.where(tri, la[:, :, None, :] - la[:, None, :, :],
                        _MASKED)
    W = G[..., None] * torch.exp(ldiff)                          # (B,Q,Q,H)
    y_intra = torch.einsum("bijh,bjhp->bihp", W, xb)
    decay_state = torch.exp(la_last[:, None, :] - la)            # (B,Q,H)
    state = (state * torch.exp(la_last)[:, :, None, None]
             + torch.einsum("bqhp,bqn->bhpn",
                            decay_state[..., None] * xb, Bq))
    return state, y_inter + y_intra


def _mamba2_mix(xh, z, dt, Bm, Cm, conv_w, A_log, D, *, Q, P,
                chunk_remat):
    """The causal conv, the SSD chunk scan, the skip and the gate of a
    whole sequence: (y (B,L,F) in z's dtype, the state after it
    (B,H,P,N)). On a mesh it runs per rank (``head_local``) over the
    rank's heads, F = H * P of them."""
    B, L, F = xh.shape
    H, nc = F // P, L // Q
    xh = _causal_conv(xh, conv_w.to(xh.dtype))
    N = Bm.shape[-1]
    A = -torch.exp(A_log)                                        # (H,) < 0
    xhh = _f32(xh.reshape(B, nc, Q, H, P))
    dtc = dt.reshape(B, nc, Q, H)
    Bc = Bm.reshape(B, nc, Q, N)
    Cc = Cm.reshape(B, nc, Q, N)
    xbar = xhh * dtc[..., None]                                  # dt-weighted input
    lda = _cumsum(dtc * A, 2)                                    # (B,nc,Q,H)
    tri = _chunk_mask(Q, xh.device)
    state = torch.zeros((B, H, P, N), dtype=xbar.dtype, device=xh.device)
    chunk = remat(_ssd_chunk, chunk_remat)
    ys = []
    for c in range(nc):
        state, y_c = chunk(state, xbar[:, c], Bc[:, c], Cc[:, c], lda[:, c],
                           tri)
        ys.append(y_c)
    y = torch.stack(ys, dim=1).reshape(B, L, H, P)
    y = y + D[None, None, :, None] * _f32(xh.reshape(B, L, H, P))
    y = y.reshape(B, L, H * P).to(z.dtype)
    return y * silu(z), state


def mamba2_train(params, cfg, x, return_state=False):
    """Chunk-parallel SSD. x: (B,L,d) -> (B,L,d) [, final state]."""
    Q = _chunks(cfg, x.shape[1])
    z, xh, Bm, Cm, dt, H, P = _mamba2_inputs(params, cfg, x)
    mix = functools.partial(_mamba2_mix, Q=Q, P=P,
                            chunk_remat=cfg.opt_chunk_remat)
    args = (xh, z, dt, Bm, Cm, params["conv_w"], params["A_log"],
            params["D"])
    dim = mamba2_head_split(params, cfg, x)
    if dim is None:
        y, state = mix(*args)
    else:
        y, state = head_local(mix, dim, x, args, _MIX_IN,
                              (("heads", 2), ("heads", 1)))
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    out = constrain(_mm(y, params["wo"]), "batch", None, "embed")
    if return_state:
        # conv cache: the last 3 *pre-conv* xh inputs (as mamba2_step uses)
        return out, {"s": state, "conv": _f32(xh[:, -3:])}
    return out


def mamba2_init_state(cfg, batch, device=None):
    d_in = cfg.ssm_expand * cfg.d_model
    H = d_in // cfg.ssm_head_dim
    return {
        "s": torch.zeros((batch, H, cfg.ssm_head_dim, cfg.ssm_state),
                         dtype=torch.float32, device=device),
        "conv": torch.zeros((batch, 3, d_in), dtype=torch.float32,
                            device=device),
    }


def mamba2_step(params, cfg, x, state):
    """x: (B,1,d). Exact recurrence: s' = s*exp(dt A) + dt B (x) x;
    y = C.s' + D x. Returns (y, new state); ``state`` is not written.

    The conv cache must hold 3 inputs: after a prompt of fewer than 3
    tokens it holds fewer, and this raises ``ValueError`` (the reference
    fails there too, inside an einsum)."""
    if state["conv"].shape[1] != 3:
        raise ValueError(
            f"{cfg.name}: the Mamba2 conv cache holds "
            f"{state['conv'].shape[1]} inputs, not 3: decoding after a "
            "prompt of fewer than 3 tokens is not supported")
    z, xh, Bm, Cm, dt, H, P = _mamba2_inputs(params, cfg, x)
    args = (xh, z, dt, Bm, Cm, params["conv_w"], params["A_log"],
            params["D"], state["s"], state["conv"])
    recur = functools.partial(_mamba2_recur, P=P)
    dim = mamba2_head_split(params, cfg, x)
    if dim is None:
        y, s_new, new_conv = recur(*args)
    else:
        y, s_new, new_conv = head_local(
            recur, dim, x, args, _MIX_IN + (("heads", 1), ("heads", 2)),
            (("heads", 2), ("heads", 1), ("heads", 2)))
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    out = constrain(_mm(y, params["wo"]), "batch", None, "embed")
    return out, {"s": s_new, "conv": new_conv}


def _mamba2_recur(xh, z, dt, Bm, Cm, conv_w, A_log, D, s, conv, *, P):
    """One token's conv, recurrence, skip and gate: (y (B,1,F) in z's
    dtype, the new state, the new conv cache). On a mesh it runs per
    rank over the rank's heads, as ``_mamba2_mix``."""
    xh = _f32(xh)
    conv_in = torch.cat([conv.to(xh.dtype), xh], dim=1)         # (B,4,F)
    xh = silu((conv_in * conv_w.to(xh.dtype)).sum(dim=1))[:, None]
    B_, H = xh.shape[0], xh.shape[-1] // P
    A = -torch.exp(A_log)
    xhh = xh.reshape(B_, H, P)
    dt1 = dt[:, 0]                                               # (B,H)
    dA = torch.exp(dt1 * A)                                      # (B,H)
    s_new = (s * dA[:, :, None, None]
             + (dt1[:, :, None] * xhh)[..., None] * Bm[:, 0][:, None, None])
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], s_new)
    y = y + D[None, :, None] * xhh
    y = y.reshape(B_, 1, H * P).to(z.dtype)
    return y * silu(z), s_new, conv_in[:, 1:]


# ---------------------------------------------------------------------------
# mLSTM (xLSTM matrix memory)
# ---------------------------------------------------------------------------

def mlstm_specs(cfg) -> dict:
    d = cfg.d_model
    d_in = cfg.ssm_expand * d
    H = cfg.num_heads
    return {
        "wz": ParamSpec((d, d_in), ("embed", "mlp")),
        "wx": ParamSpec((d, d_in), ("embed", "mlp")),
        "wq": ParamSpec((d_in, d_in), ("mlp", "heads")),
        "wk": ParamSpec((d_in, d_in), ("mlp", "heads")),
        "wv": ParamSpec((d_in, d_in), ("mlp", "heads")),
        "wi": ParamSpec((d_in, H), ("mlp", "heads"), scale=0.02),
        "wf": ParamSpec((d_in, H), ("mlp", "heads"), scale=0.02),
        "bi": ParamSpec((H,), ("heads",), init="zeros"),
        "bf": ParamSpec((H,), ("heads",), init="ones"),  # bias toward remembering
        "norm": ParamSpec((d_in,), ("mlp",), init="ones"),
        "wo": ParamSpec((d_in, d), ("mlp", "embed")),
    }


def _mlstm_inputs(params, cfg, x):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.num_heads
    P = d_in // H
    B, L, _ = x.shape
    z = _mm(x, params["wz"])
    xp = _mm(x, params["wx"])
    q = _mm(xp, params["wq"]).reshape(B, L, H, P)
    k = _mm(xp, params["wk"]).reshape(B, L, H, P)
    v = _mm(xp, params["wv"]).reshape(B, L, H, P)
    li = _f32(_mm(xp, params["wi"])) + params["bi"]              # log input gate
    lf = log_sigmoid(_f32(_mm(xp, params["wf"])) + params["bf"])  # log forget gate
    scale = P ** -0.5
    return z, _f32(q) * scale, _f32(k), _f32(v), li, lf, H, P


def _mlstm_chunk(C, n, qc, kc, vc, lic, lfcc, tri):
    """One chunk of the chunked mLSTM: (C, n after it, its output
    (B,Q,H,P))."""
    lf_last = lfcc[:, -1]                                        # (B,H)
    # inter-chunk
    e = torch.exp(lfcc)                                          # (B,Q,H)
    y_inter = torch.einsum("bqhp,bhpo->bqho", qc, C) * e[..., None]
    den_inter = torch.einsum("bqhp,bhp->bqh", qc, n) * e
    # intra-chunk: D_ij = exp(lfc_i - lfc_j + li_j), j <= i
    ldm = (lfcc[:, :, None, :] - lfcc[:, None, :, :]
           + lic[:, None, :, :])                                 # (B,Q,Q,H)
    Dm = torch.exp(torch.where(tri, ldm, _MASKED))  # mask inside the exponent
    S = torch.einsum("bihp,bjhp->bijh", qc, kc)                  # scores
    W = Dm * S
    y_intra = torch.einsum("bijh,bjho->biho", W, vc)
    den_intra = W.sum(dim=2)                                     # (B,Q,H)
    # state update
    wdec = torch.exp(lf_last[:, None, :] - lfcc + lic)           # (B,Q,H)
    C = (C * torch.exp(lf_last)[:, :, None, None]
         + torch.einsum("bqhp,bqho->bhpo", wdec[..., None] * kc, vc))
    n = (n * torch.exp(lf_last)[:, :, None]
         + (wdec[..., None] * kc).sum(dim=1))
    num = y_inter + y_intra
    den = den_inter + den_intra
    return C, n, num / torch.clamp_min(den.abs(), 1.0)[..., None]


def mlstm_train(params, cfg, x, return_state=False):
    """Chunked linear-attention form (no stabilizer; fp32 log-space)."""
    B, L, d = x.shape
    Q = _chunks(cfg, L)
    nc = L // Q
    z, q, k, v, li, lf, H, P = _mlstm_inputs(params, cfg, x)
    lfc = _cumsum(lf.reshape(B, nc, Q, H), 2)                    # cum log f
    qs, ks, vs, lis = (t.reshape(B, nc, Q, *t.shape[2:]) for t in (q, k, v, li))
    tri = _chunk_mask(Q, x.device)
    C = torch.zeros((B, H, P, P), dtype=q.dtype, device=x.device)
    n = torch.zeros((B, H, P), dtype=q.dtype, device=x.device)
    chunk = remat(_mlstm_chunk, cfg.opt_chunk_remat)
    ys = []
    for c in range(nc):
        C, n, h = chunk(C, n, qs[:, c], ks[:, c], vs[:, c], lis[:, c],
                        lfc[:, c], tri)
        ys.append(h)
    y = torch.stack(ys, dim=1).reshape(B, L, H * P).to(x.dtype)
    y = y * silu(z)
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    out = _mm(y, params["wo"])
    if return_state:
        # m=0 is consistent: the chunked path is the unstabilized recurrence
        return out, {"C": C, "n": n,
                     "m": torch.zeros((B, H), dtype=q.dtype,
                                      device=x.device)}
    return out


def mlstm_init_state(cfg, batch, device=None):
    d_in = cfg.ssm_expand * cfg.d_model
    H = cfg.num_heads
    P = d_in // H
    f32 = dict(dtype=torch.float32, device=device)
    return {"C": torch.zeros((batch, H, P, P), **f32),
            "n": torch.zeros((batch, H, P), **f32),
            "m": torch.zeros((batch, H), **f32)}


def mlstm_step(params, cfg, x, state):
    """Stabilized exact recurrence (one token). x: (B,1,d). Returns (y,
    new state); ``state`` is not written."""
    z, q, k, v, li, lf, H, P = _mlstm_inputs(params, cfg, x)
    q1, k1, v1 = q[:, 0], k[:, 0], v[:, 0]                       # (B,H,P)
    li1, lf1 = li[:, 0], lf[:, 0]                                # (B,H)
    m_new = torch.maximum(lf1 + state["m"], li1)
    fs = torch.exp(lf1 + state["m"] - m_new)                     # (B,H)
    is_ = torch.exp(li1 - m_new)
    C_new = state["C"] * fs[:, :, None, None] + is_[:, :, None, None] * (
        k1[..., :, None] * v1[..., None, :])
    n_new = state["n"] * fs[:, :, None] + is_[:, :, None] * k1
    num = torch.einsum("bhp,bhpo->bho", q1, C_new)
    den = (q1 * n_new).sum(dim=-1)
    h = num / torch.maximum(den.abs(), torch.exp(-m_new))[..., None]
    y = h.reshape(x.shape[0], 1, H * P).to(x.dtype)
    y = y * silu(z)
    y = rmsnorm(y, params["norm"], cfg.norm_eps)
    return _mm(y, params["wo"]), {"C": C_new, "n": n_new, "m": m_new}


# ---------------------------------------------------------------------------
# sLSTM (xLSTM scalar memory, sequential)
# ---------------------------------------------------------------------------

def slstm_specs(cfg) -> dict:
    d = cfg.d_model
    sp = {}
    for g in ("i", "f", "z", "o"):
        sp[f"w{g}"] = ParamSpec((d, d), ("embed", "mlp"), scale=0.02)
        sp[f"r{g}"] = ParamSpec((d, d), ("mlp", "mlp"), scale=0.02)
        sp[f"b{g}"] = ParamSpec((d,), ("mlp",),
                                init="ones" if g == "f" else "zeros")
    return sp


def slstm_init_state(cfg, batch, device=None):
    return {name: torch.zeros((batch, cfg.d_model), dtype=torch.float32,
                              device=device) for name in ("c", "n", "h", "m")}


def _slstm_cell(params, x_t, st):
    """x_t: (B,d) fp32; one stabilized sLSTM step."""
    h = st["h"].to(x_t.dtype)

    def gate(g):
        return (x_t @ params[f"w{g}"].to(x_t.dtype)
                + h @ params[f"r{g}"].to(x_t.dtype) + params[f"b{g}"])

    li = gate("i")                                               # log input gate
    lf = log_sigmoid(gate("f"))                                  # log forget gate
    zt = torch.tanh(gate("z"))
    ot = torch.sigmoid(gate("o"))
    m_new = torch.maximum(lf + st["m"], li)
    fs = torch.exp(lf + st["m"] - m_new)
    is_ = torch.exp(li - m_new)
    c_new = fs * st["c"] + is_ * zt
    n_new = torch.maximum(fs * st["n"] + is_, torch.exp(-m_new))
    h_new = ot * c_new / n_new
    return {"c": c_new, "n": n_new, "h": h_new, "m": m_new}


def _time_loop(step, L: int, shape, dtype, device, graph: bool
               ) -> torch.Tensor:
    """``torch.stack([step(t) for t in range(L)], dim=1)`` of shape
    ``shape`` for a recurrence whose steps issue the same ops on the same
    shapes. Without an autograd ``graph`` each step's output is copied
    into one preallocated ``dtype`` output as it comes, so the peak holds
    the output and one step. The dry run's ``StepRecorder`` (the current
    dispatch mode, found by duck typing: ``models`` does not import
    ``launch``) offers ``repeat``: over meta tensors, which carry no
    values, step 0 alone runs under ``mode.repeat(L)``. FLOPs, bytes, op
    count and collective bytes then equal the full loop's exactly; the
    peak equals it to within one carry state (4 x ``(B, d)`` float32 in
    the sLSTM). With a ``graph`` the steps' outputs are stacked: a
    ``copy_`` into one output would copy its whole gradient at every
    step of the backward."""
    if graph:
        return torch.stack([step(t) for t in range(L)], dim=1)
    out = torch.empty(shape, dtype=dtype, device=device)
    repeat = getattr(_get_current_dispatch_mode(), "repeat", None)
    if repeat is not None and device.type == "meta" and L > 0:
        with repeat(L):
            out.select(1, 0).copy_(step(0))
        return out
    for t in range(L):
        out.select(1, t).copy_(step(t))
    return out


def slstm_train(params, cfg, x, return_state=False):
    """Sequential loop over time (``_time_loop``). x: (B,L,d) ->
    (B,L,d)."""
    B, L, d = x.shape
    xf = _f32(x)
    st = slstm_init_state(cfg, B, x.device)

    def step(t):
        nonlocal st
        st = _slstm_cell(params, xf[:, t], st)
        return st["h"]
    graph = torch.is_grad_enabled() and (xf.requires_grad or any(
        w.requires_grad for w in params.values()))
    out = _time_loop(step, L, (B, L, d), xf.dtype, x.device,
                     graph).to(x.dtype)
    if return_state:
        return out, st
    return out


def slstm_step(params, cfg, x, state):
    """One token. Returns (h (B,1,d) in x's dtype, new state)."""
    st = _slstm_cell(params, _f32(x[:, 0]), state)
    return st["h"][:, None].to(x.dtype), st


__all__ = ["log_sigmoid", "mamba2_init_state", "mamba2_specs", "mamba2_step",
           "mamba2_train", "mlstm_init_state", "mlstm_specs", "mlstm_step",
           "mlstm_train", "slstm_init_state", "slstm_specs", "slstm_step",
           "slstm_train", "softplus"]
