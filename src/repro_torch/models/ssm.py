"""State-space / recurrent blocks: xLSTM (mLSTM + sLSTM) and Mamba2 (SSD).

The counterpart of ``repro.models.ssm``.  Both families have a *parallel*
path (``forward``) and a *recurrent* one-token path (decode, and the
sequential prefill the serving path scans):

  mLSTM  -- stabilised parallel form: decay matrix D from forget-gate
            log-sigmoid cumsums, max-stabilised; a chunkwise form carries
            the matrix memory between chunks.
  sLSTM  -- exponential-gated scalar LSTM with a per-head block-diagonal
            recurrence; its parallel path is a loop over time.
  Mamba2 -- the chunked SSD algorithm (intra-chunk quadratic + inter-chunk
            state scan).

Every projection goes through ``repro_torch.core.ops.matmul`` (the systolic
kernel on the card); the recurrences and the SSD are plain torch.  The
reference's ``lax.scan`` bodies are Python loops here.  The dtypes are the
reference's: where it asks for fp32 accumulation the einsums run in fp32,
where it casts to the compute dtype the cast is made at the same point, and
the states C, n, m, h and the SSM state are fp32 (the conv windows are in
the compute dtype).  The leaves that enter fp32 arithmetic (``conv_w``,
``conv_b``, ``a_log``, ``dt_bias``, ``d_skip``, ``b_if``, ``b``, ``r_h``)
stay fp32 whatever the compute dtype (``layers.FP32_KEYS``).
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F

from repro_torch.core import ops
from repro_torch.models import layers
from repro_torch.models.config import ArchConfig

F32 = torch.float32


def _randn(gen: torch.Generator, shape: tuple, scale: float) -> torch.Tensor:
    return torch.randn(shape, generator=gen, device=gen.device, dtype=F32) * scale


def _tril(t: int, device: torch.device) -> torch.Tensor:
    return torch.ones((t, t), dtype=torch.bool, device=device).tril()


def _causal_conv(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Depthwise causal 1-D conv.  x: (B, T, C), w: (K, C)."""
    k, t = w.shape[0], x.shape[1]
    xp = F.pad(x, (0, 0, k - 1, 0))
    return sum(xp[:, i : i + t] * w[i] for i in range(k))


# ===========================================================================
# mLSTM (matrix-memory LSTM)
# ===========================================================================


def init_mlstm(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = cfg.n_heads
    assert di % nh == 0
    dev = gen.device
    return {
        "w_up": layers._dense_init(gen, d, 2 * di, dtype),  # (inner, z-gate)
        "conv_w": _randn(gen, (s.conv_kernel, di), 0.1),
        "wq": layers._dense_init(gen, di, di, dtype),
        "wk": layers._dense_init(gen, di, di, dtype),
        "wv": layers._dense_init(gen, di, di, dtype),
        "w_if": layers._dense_init(gen, di, 2 * nh, dtype),  # input & forget gate pre-acts
        "b_if": torch.cat([torch.zeros(nh, device=dev), torch.linspace(3.0, 6.0, nh, device=dev)]),
        "skip_norm": layers.init_rmsnorm(di, dev),
        "w_down": layers._dense_init(gen, di, d, dtype),
    }


def _mlstm_in(params: dict, x: torch.Tensor, cfg: ArchConfig):
    """The parallel paths' shared front: up-projection, causal conv, q/k/v and
    the gate pre-activations.  -> (z, conv, q, k, v, i_pre, log_f)."""
    b, t, d = x.shape
    di = cfg.ssm.expand * d
    nh = cfg.n_heads
    hd = di // nh
    up = ops.matmul(x, layers.wcast(params["w_up"], x.dtype))
    inner, z = up[..., :di], up[..., di:]
    conv = F.silu(_causal_conv(inner.float(), params["conv_w"]).to(x.dtype))
    q = ops.matmul(conv, layers.wcast(params["wq"], x.dtype)).reshape(b, t, nh, hd)
    k = ops.matmul(conv, layers.wcast(params["wk"], x.dtype)).reshape(b, t, nh, hd)
    v = ops.matmul(inner, layers.wcast(params["wv"], x.dtype)).reshape(b, t, nh, hd)
    gates = ops.matmul(conv, layers.wcast(params["w_if"], x.dtype), out_dtype=F32) + params["b_if"]
    i_pre, f_pre = gates[..., :nh], gates[..., nh:]  # (B, T, nh)
    return z, conv, q, k, v, i_pre, F.logsigmoid(f_pre)


def _mlstm_out(params: dict, h: torch.Tensor, conv: torch.Tensor, z: torch.Tensor, cfg: ArchConfig,
               dtype: torch.dtype) -> torch.Tensor:
    h = layers.rmsnorm(params["skip_norm"], h, cfg.norm_eps) + conv
    h = h * F.silu(z.float()).to(h.dtype)
    return ops.matmul(h, layers.wcast(params["w_down"], dtype))


def mlstm_fwd(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Parallel (stabilised) mLSTM, the quadratic oracle.  x: (B, T, d) -> (B, T, d)."""
    b, t, d = x.shape
    di = cfg.ssm.expand * d
    hd = di // cfg.n_heads
    z, conv, q, k, v, i_pre, log_f = _mlstm_in(params, x, cfg)
    a = torch.cumsum(log_f, dim=1)  # (B, T, nh) cumulative log decay

    # D_tilde[t, s] = a_t - a_s + i_s  for s <= t
    d_t = a[:, :, None, :] - a[:, None, :, :] + i_pre[:, None, :, :]
    d_t = torch.where(_tril(t, x.device)[None, :, :, None], d_t, -math.inf)
    m = d_t.amax(dim=2, keepdim=True)  # stabiliser per (b, t, h)
    dmat = torch.exp(d_t - m)  # (B, T, T, nh)

    scores = torch.einsum("bthd,bshd->btsh", q.float(), k.float()) * hd**-0.5
    sw = scores * dmat
    norm = torch.maximum(sw.sum(dim=2).abs(), torch.exp(-m[:, :, 0]))
    h = ops.einsum("btsh,bshd->bthd", sw.to(v.dtype), v)
    h = (h / norm[..., None].to(h.dtype)).reshape(b, t, di)
    return _mlstm_out(params, h, conv, z, cfg, x.dtype)


def mlstm_fwd_chunked(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Chunkwise-parallel stabilised mLSTM, O(T * chunk) memory: a per-chunk
    quadratic (intra) and a matrix-memory state carried between chunks
    (inter), with the exp-gate max-stabilisers carried exactly.  The two
    scans over chunks (stabiliser, state) are elementwise Python loops."""
    s = cfg.ssm
    b, t, d = x.shape
    di = s.expand * d
    nh = cfg.n_heads
    hd = di // nh
    q_c = s.chunk_size
    assert t % q_c == 0, (t, q_c)
    nc = t // q_c
    z, conv, q, k, v, i_pre, log_f = _mlstm_in(params, x, cfg)

    def r(a):  # chunked views: (B, nc, Q, ...)
        return a.reshape(b, nc, q_c, *a.shape[2:])

    qc, kc, vc = r(q), r(k), r(v)
    ic, lfc = r(i_pre), r(log_f)
    kf = kc.float() * hd**-0.5

    fcum = torch.cumsum(lfc, dim=2)  # F_t within chunk (B, nc, Q, H)
    g = fcum[:, :, -1, :]  # total chunk decay (B, nc, H)

    # ---- per-chunk summaries with LOCAL stabilisers -------------------------
    a_src = g[:, :, None, :] - fcum + ic  # weight of source s into the end-of-chunk state
    m_loc = a_src.amax(dim=2)  # (B, nc, H)
    w_src = torch.exp(a_src - m_loc[:, :, None, :])  # (B, nc, Q, H)
    kw = kf * w_src[..., None]
    s_c = torch.einsum("bcqhk,bcqhv->bchkv", kw, vc.float())  # (B, nc, H, hd, hd)
    n_c = kw.sum(dim=2)  # (B, nc, H, hd)

    # ---- stabiliser scan (scalar per (B, H)) ---------------------------------
    m_prev = torch.full((b, nh), -math.inf, dtype=F32, device=x.device)
    m_prevs = []
    for c in range(nc):
        m_prevs.append(m_prev)
        m_prev = torch.maximum(m_prev + g[:, c], m_loc[:, c])
    m_prevs = torch.stack(m_prevs, dim=1)  # m_{c-1} per chunk (B, nc, H)
    m_curr = torch.maximum(m_prevs + g, m_loc)  # m_c per chunk

    # ---- state scan -----------------------------------------------------------
    decay_c = torch.exp(m_prevs + g - m_curr)  # carry scale (B, nc, H)
    inject_c = torch.exp(m_loc - m_curr)  # local-sum scale
    c_state = torch.zeros((b, nh, hd, hd), dtype=F32, device=x.device)
    n_state = torch.zeros((b, nh, hd), dtype=F32, device=x.device)
    c_prevs, n_prevs = [], []
    for c in range(nc):
        c_prevs.append(c_state)
        n_prevs.append(n_state)
        dec, inj = decay_c[:, c], inject_c[:, c]
        c_state = c_state * dec[..., None, None] + inj[..., None, None] * s_c[:, c]
        n_state = n_state * dec[..., None] + inj[..., None] * n_c[:, c]
    c_prevs = torch.stack(c_prevs, dim=1)  # C_{c-1} (B, nc, H, hd, hd)
    n_prevs = torch.stack(n_prevs, dim=1)  # n_{c-1} (B, nc, H, hd)

    # ---- outputs (vectorised over chunks) -------------------------------------
    # intra: D[t, s] = F_t - F_s + i_s  (s <= t)
    d_ts = fcum[:, :, :, None, :] - fcum[:, :, None, :, :] + ic[:, :, None, :, :]
    d_ts = torch.where(_tril(q_c, x.device)[None, None, :, :, None], d_ts, -math.inf)
    m_intra = d_ts.amax(dim=3)  # (B, nc, Q, H)
    b_inter = fcum + m_prevs[:, :, None, :]  # inter weight exponent: F_t + m_{c-1}
    m_t = torch.maximum(m_intra, b_inter)  # (B, nc, Q, H)
    w_intra = torch.exp(d_ts - m_t[:, :, :, None, :])  # (B, nc, Q, Q, H)
    w_inter = torch.exp(b_inter - m_t)  # (B, nc, Q, H)

    qf = qc.float()
    sw = torch.einsum("bcthd,bcshd->bctsh", qf, kf) * w_intra
    h_intra = torch.einsum("bctsh,bcshd->bcthd", sw, vc.float())
    h_inter = torch.einsum("bcthd,bchdv->bcthv", qf, c_prevs) * w_inter[..., None]
    den_intra = sw.sum(dim=3)  # (B, nc, Q, H)
    den_inter = torch.einsum("bcthd,bchd->bcth", qf, n_prevs) * w_inter
    den = torch.maximum((den_intra + den_inter).abs(), torch.exp(-m_t))
    h = (h_intra + h_inter) / den[..., None]
    h = h.reshape(b, t, di).to(x.dtype)
    return _mlstm_out(params, h, conv, z, cfg, x.dtype)


def mlstm_auto(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """The chunked form when the sequence is a multiple of the chunk size
    (and longer than one); the quadratic oracle otherwise."""
    t = x.shape[1]
    q_c = cfg.ssm.chunk_size
    if t > q_c and t % q_c == 0:
        return mlstm_fwd_chunked(params, x, cfg)
    return mlstm_fwd(params, x, cfg)


def init_mlstm_state(cfg: ArchConfig, batch: int, dtype: torch.dtype, device: torch.device) -> dict:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = cfg.n_heads
    hd = di // nh
    return {
        "C": torch.zeros((batch, nh, hd, hd), dtype=F32, device=device),
        "n": torch.zeros((batch, nh, hd), dtype=F32, device=device),
        "m": torch.full((batch, nh), -math.inf, dtype=F32, device=device),
        "conv": torch.zeros((batch, s.conv_kernel - 1, di), dtype=dtype, device=device),
    }


def mlstm_step(params: dict, x: torch.Tensor, cfg: ArchConfig, state: dict):
    """One-token recurrent mLSTM.  x: (B, 1, d) -> (y (B, 1, d), new state).
    The first step after ``init_mlstm_state`` has m = -inf, and
    exp(log_f + m - m_new) is then 0: the empty memory carries nothing."""
    s = cfg.ssm
    b, _, d = x.shape
    di = s.expand * d
    nh = cfg.n_heads
    hd = di // nh

    up = ops.matmul(x[:, 0], layers.wcast(params["w_up"], x.dtype))
    inner, z = up[..., :di], up[..., di:]
    win = torch.cat([state["conv"], inner[:, None]], dim=1)  # (B, K, di)
    conv = F.silu((win.float() * params["conv_w"]).sum(dim=1)).to(x.dtype)
    q = ops.matmul(conv, layers.wcast(params["wq"], x.dtype)).reshape(b, nh, hd)
    k = ops.matmul(conv, layers.wcast(params["wk"], x.dtype)).reshape(b, nh, hd)
    v = ops.matmul(inner, layers.wcast(params["wv"], x.dtype)).reshape(b, nh, hd)
    gates = ops.matmul(conv, layers.wcast(params["w_if"], x.dtype), out_dtype=F32) + params["b_if"]
    i_pre, f_pre = gates[..., :nh], gates[..., nh:]
    log_f = F.logsigmoid(f_pre)  # (B, nh)

    m_new = torch.maximum(log_f + state["m"], i_pre)
    f_eff = torch.exp(log_f + state["m"] - m_new)[..., None]
    i_eff = torch.exp(i_pre - m_new)[..., None]
    kf = k.float() * hd**-0.5
    c_new = state["C"] * f_eff[..., None] + i_eff[..., None] * (kf[..., :, None] * v.float()[..., None, :])
    n_new = state["n"] * f_eff + i_eff * kf
    qf = q.float()
    num = torch.einsum("bhkv,bhk->bhv", c_new, qf)
    den = torch.maximum(torch.einsum("bhk,bhk->bh", n_new, qf).abs(), torch.exp(-m_new))
    h = (num / den[..., None]).reshape(b, di).to(x.dtype)
    y = _mlstm_out(params, h, conv, z, cfg, x.dtype)[:, None]
    return y, {"C": c_new, "n": n_new, "m": m_new, "conv": win[:, 1:]}


# ===========================================================================
# sLSTM (scalar-memory LSTM with exponential gating)
# ===========================================================================


def init_slstm(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    d = cfg.d_model
    nh = cfg.n_heads
    hd = d // nh
    dev = gen.device
    d_up = int(4 * d / 3 / 8) * 8 or 8
    return {
        # 4 gates (z, i, f, o): input + per-head block-diagonal recurrent
        "w_x": layers._dense_init(gen, d, 4 * d, dtype),
        "r_h": _randn(gen, (nh, hd, 4 * hd), hd**-0.5),
        "b": torch.cat([torch.zeros(2 * d, device=dev), torch.full((d,), 3.0, device=dev),
                        torch.zeros(d, device=dev)]),
        "mlp": layers.init_swiglu(gen, d, d_up, dtype),
        "mlp_norm": layers.init_rmsnorm(d, dev),
    }


def init_slstm_state(cfg: ArchConfig, batch: int, dtype: torch.dtype, device: torch.device) -> dict:
    """All fp32, whatever ``dtype`` (taken for the reference's signature)."""
    d = cfg.d_model
    return {
        "c": torch.zeros((batch, d), dtype=F32, device=device),
        "n": torch.zeros((batch, d), dtype=F32, device=device),
        "m": torch.full((batch, d), -math.inf, dtype=F32, device=device),
        "h": torch.zeros((batch, d), dtype=F32, device=device),
    }


def _slstm_cell(params: dict, xt: torch.Tensor, state: dict, nh: int) -> dict:
    """xt: (B, 4d) fp32 pre-activation from the input; the state's h enters
    through the per-head recurrence R."""
    b, d4 = xt.shape
    d = d4 // 4
    hd = d // nh
    h_heads = state["h"].reshape(b, nh, hd)
    rec = torch.einsum("bhk,hkj->bhj", h_heads, params["r_h"]).reshape(b, 4 * d)
    pre = xt + rec + params["b"]
    z, i_pre, f_pre, o_pre = pre.chunk(4, dim=-1)
    z = torch.tanh(z)
    o = torch.sigmoid(o_pre)
    log_f = F.logsigmoid(f_pre)
    m_new = torch.maximum(log_f + state["m"], i_pre)
    i_eff = torch.exp(i_pre - m_new)
    f_eff = torch.exp(log_f + state["m"] - m_new)
    c_new = f_eff * state["c"] + i_eff * z
    n_new = f_eff * state["n"] + i_eff
    h_new = o * c_new / n_new.clamp_min(1e-6)
    return {"c": c_new, "n": n_new, "m": m_new, "h": h_new}


def _slstm_mlp(params: dict, h: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    return h + layers.swiglu(params["mlp"], layers.rmsnorm(params["mlp_norm"], h, cfg.norm_eps))


def slstm_fwd(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Sequential sLSTM (a loop over T) + gated MLP.  x: (B, T, d)."""
    b, t, _ = x.shape
    xg = ops.matmul(x, params["w_x"].to(x.dtype), out_dtype=F32)
    state = init_slstm_state(cfg, b, x.dtype, x.device)
    hs = []
    for i in range(t):
        state = _slstm_cell(params, xg[:, i], state, cfg.n_heads)
        hs.append(state["h"])
    return _slstm_mlp(params, torch.stack(hs, dim=1).to(x.dtype), cfg)


def slstm_step(params: dict, x: torch.Tensor, cfg: ArchConfig, state: dict):
    """One-token sLSTM.  x: (B, 1, d) -> (y (B, 1, d), new state)."""
    xg = ops.matmul(x[:, 0], params["w_x"].to(x.dtype), out_dtype=F32)
    new = _slstm_cell(params, xg, state, cfg.n_heads)
    return _slstm_mlp(params, new["h"].to(x.dtype), cfg)[:, None], new


# ===========================================================================
# Mamba2 (SSD)
# ===========================================================================


def init_mamba2(gen: torch.Generator, cfg: ArchConfig, dtype: torch.dtype) -> dict:
    s = cfg.ssm
    d = cfg.d_model
    di = s.expand * d
    nh = di // s.head_dim
    gn = s.n_groups * s.state_size
    conv_ch = di + 2 * gn
    dev = gen.device
    return {
        "in_proj": layers._dense_init(gen, d, 2 * di + 2 * gn + nh, dtype),  # z, x, B, C, dt
        "conv_w": _randn(gen, (s.conv_kernel, conv_ch), 0.1),
        "conv_b": torch.zeros((conv_ch,), device=dev),
        "a_log": torch.log(torch.linspace(1.0, 16.0, nh, device=dev)),
        "dt_bias": torch.log(torch.expm1(torch.linspace(1e-3, 1e-1, nh, device=dev))),
        "d_skip": torch.ones((nh,), device=dev),
        "gate_norm": layers.init_rmsnorm(di, dev),
        "out_proj": layers._dense_init(gen, di, d, dtype),
    }


def _segsum(a: torch.Tensor) -> torch.Tensor:
    """L[t, s] = sum_{s < r <= t} a_r for s <= t, else -inf.  a: (..., T)."""
    t = a.shape[-1]
    cs = torch.cumsum(a, dim=-1)
    diff = cs[..., :, None] - cs[..., None, :]
    return torch.where(_tril(t, a.device), diff, -math.inf)


def _ssd_chunked(xh, dt, a, bmat, cmat, chunk: int):
    """SSD over one sequence.

    xh: (B, T, H, P); dt: (B, T, H) fp32 (post-softplus); a: (H,) (negative);
    bmat / cmat: (B, T, H, N) (groups already repeated to the heads).
    -> (y (B, T, H, P) in xh's dtype, final state (B, H, P, N) fp32).
    """
    b, t, h, p = xh.shape
    n = bmat.shape[-1]
    assert t % chunk == 0, (t, chunk)
    nc = t // chunk

    def r(z):
        return z.reshape(b, nc, chunk, *z.shape[2:])

    xc, dtc, bc, cc = r(xh), r(dt), r(bmat), r(cmat)
    da = dtc * a  # (B, nc, Q, H) log-decay per step
    da_cs = torch.cumsum(da, dim=2)

    # intra-chunk (diagonal): y[t] = sum_{s<=t} C_t.B_s exp(cum_t - cum_s) dt_s x_s
    lmat = torch.exp(_segsum(da.permute(0, 1, 3, 2)))  # (B, nc, H, Q, Q)
    scores = torch.einsum("bcthn,bcshn->bchts", cc.float(), bc.float())
    w = scores * lmat * dtc.permute(0, 1, 3, 2)[:, :, :, None, :]
    y_diag = ops.einsum("bchts,bcshp->bcthp", w.to(xh.dtype), xc)

    # chunk states: S_c = sum_s exp(cum_end - cum_s) dt_s B_s x_s^T
    decay_to_end = torch.exp(da_cs[:, :, -1:, :] - da_cs)  # (B, nc, Q, H)
    sw = (decay_to_end * dtc)[..., None]  # (B, nc, Q, H, 1)
    states = ops.einsum("bcshp,bcshn->bchpn", xc * sw.to(xh.dtype), bc, out_dtype=F32)  # (B, nc, H, P, N)

    # inter-chunk recurrence, emitting the state *before* each chunk
    chunk_decay = torch.exp(da_cs[:, :, -1, :])  # (B, nc, H)
    carry = torch.zeros((b, h, p, n), dtype=F32, device=xh.device)
    prev = []
    for c in range(nc):
        prev.append(carry)
        carry = carry * chunk_decay[:, c, :, None, None] + states[:, c]
    prev_states = torch.stack(prev, dim=1)  # (B, nc, H, P, N)

    # off-diagonal: y[t] += C_t . (exp(cum_t) * S_prev)
    y_off = ops.einsum("bcthn,bchpn->bcthp", cc, prev_states.to(cc.dtype))
    y_off = y_off * torch.exp(da_cs)[..., None].to(xh.dtype)
    return (y_diag + y_off).reshape(b, t, h, p), carry


def _mamba2_split(conv: torch.Tensor, cfg: ArchConfig):
    """The conv output's x, B and C, the groups repeated to the heads
    (``repeat_interleave``: head i reads group i // rep).  conv: (..., di + 2gn)."""
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    gn = s.n_groups * s.state_size
    lead = conv.shape[:-1]
    rep = nh // s.n_groups
    xin = conv[..., :di].reshape(*lead, nh, s.head_dim)
    bmat = conv[..., di : di + gn].reshape(*lead, s.n_groups, s.state_size).repeat_interleave(rep, dim=-2)
    cmat = conv[..., di + gn :].reshape(*lead, s.n_groups, s.state_size).repeat_interleave(rep, dim=-2)
    return xin, bmat, cmat


def _mamba2_out(params: dict, y: torch.Tensor, z: torch.Tensor, cfg: ArchConfig, dtype: torch.dtype):
    y = layers.rmsnorm(params["gate_norm"], y, cfg.norm_eps)
    y = y * F.silu(z.float()).to(y.dtype)
    return ops.matmul(y, params["out_proj"].to(dtype))


def mamba2_fwd(params: dict, x: torch.Tensor, cfg: ArchConfig) -> torch.Tensor:
    """Parallel Mamba2 (SSD).  x: (B, T, d) -> (B, T, d)."""
    s = cfg.ssm
    b, t, d = x.shape
    di = s.expand * d
    nh = di // s.head_dim
    gn = s.n_groups * s.state_size

    proj = ops.matmul(x, params["in_proj"].to(x.dtype))
    z = proj[..., :di]
    xbc = proj[..., di : di + di + 2 * gn]
    dt_pre = proj[..., -nh:]
    conv = F.silu(_causal_conv(xbc.float(), params["conv_w"]) + params["conv_b"]).to(x.dtype)
    xin, bmat, cmat = _mamba2_split(conv, cfg)

    dt = F.softplus(dt_pre.float() + params["dt_bias"])
    a = -torch.exp(params["a_log"])  # (H,)

    pad = (-t) % s.chunk_size
    xs, dts, bs, cs = xin, dt, bmat, cmat
    if pad:
        xs, bs, cs = (F.pad(u, (0, 0, 0, 0, 0, pad)) for u in (xin, bmat, cmat))
        dts = F.pad(dt, (0, 0, 0, pad))
    y, _ = _ssd_chunked(xs, dts, a, bs, cs, s.chunk_size)
    y = y[:, :t]
    y = y + xin * params["d_skip"][None, None, :, None].to(y.dtype)
    return _mamba2_out(params, y.reshape(b, t, di), z, cfg, x.dtype)


def init_mamba2_state(cfg: ArchConfig, batch: int, dtype: torch.dtype, device: torch.device) -> dict:
    s = cfg.ssm
    di = s.expand * cfg.d_model
    nh = di // s.head_dim
    gn = s.n_groups * s.state_size
    return {
        "ssm": torch.zeros((batch, nh, s.head_dim, s.state_size), dtype=F32, device=device),
        "conv": torch.zeros((batch, s.conv_kernel - 1, di + 2 * gn), dtype=dtype, device=device),
    }


def mamba2_step(params: dict, x: torch.Tensor, cfg: ArchConfig, state: dict):
    """One-token recurrent Mamba2.  x: (B, 1, d) -> (y (B, 1, d), new state)."""
    s = cfg.ssm
    b, _, d = x.shape
    di = s.expand * d
    nh = di // s.head_dim
    gn = s.n_groups * s.state_size

    proj = ops.matmul(x[:, 0], params["in_proj"].to(x.dtype))
    z = proj[..., :di]
    xbc = proj[..., di : di + di + 2 * gn]
    dt_pre = proj[..., -nh:]

    win = torch.cat([state["conv"], xbc[:, None]], dim=1)
    conv = F.silu((win.float() * params["conv_w"]).sum(dim=1) + params["conv_b"]).to(x.dtype)
    xin, bmat, cmat = _mamba2_split(conv, cfg)
    dt = F.softplus(dt_pre.float() + params["dt_bias"])  # (B, H)
    a = -torch.exp(params["a_log"])
    da = torch.exp(dt * a)[..., None, None]  # (B, H, 1, 1)

    xf = xin.float()
    ssm = state["ssm"] * da + (dt[..., None] * xf)[..., :, None] * bmat.float()[..., None, :]
    y = torch.einsum("bhpn,bhn->bhp", ssm, cmat.float())
    y = y + xf * params["d_skip"][None, :, None]
    y = y.reshape(b, di).to(x.dtype)
    return _mamba2_out(params, y, z, cfg, x.dtype)[:, None], {"ssm": ssm, "conv": win[:, 1:]}
