"""xLSTM blocks, the mLSTM (matrix memory) and sLSTM (scalar memory)
mixers of xLSTM-1.3B (port of ``repro.models.xlstm`` at tp=1; arXiv
2405.04517).

A layer's state is the conv history ``conv`` (B, K-1, width) in the model
dtype and the recurrent state in f32: the mLSTM's per-head matrix memory
``c`` (B, H, dh, dh), normaliser ``n`` (B, H, dh) and stabiliser ``m`` (B,
H); the sLSTM's ``c``, ``n``, ``m`` (B, D) and its last output ``h`` (B,
D) in the model dtype.  JAX runs these recurrences as ``lax.scan``s of
plain ``jnp`` ops, outside any Pallas kernel; here they are loops of plain
torch ops on any device.  ``mlstm_full`` runs the sequential recurrence,
as JAX's default does; the chunkwise-parallel form (``mlstm_chunkwise``)
is kept beside it and held to JAX's, but nothing on the serving path calls
it.  The packed step advances each token's slot state one token at a time
and commits it only for active tokens, as ``mamba_packed`` does.
"""
from __future__ import annotations

from typing import Optional

import torch

from repro_torch.configs.base import ModelConfig, XLSTMConfig
from repro_torch.models.layers import (causal_conv1d, causal_conv1d_step,
                                       conv_packed, conv_tail, rmsnorm,
                                       silu)
from repro_torch.models.param import DTYPES, ParamDef

# the initial stabiliser of a cache; the sequential recurrence without an
# initial state starts from -inf instead (JAX's two rules, kept apart)
M_INIT = -1e30


def _xc(cfg: ModelConfig) -> XLSTMConfig:
    return cfg.xlstm or XLSTMConfig()


def _mlstm_dims(cfg: ModelConfig) -> tuple[int, int, int]:
    d_in = int(_xc(cfg).proj_factor * cfg.d_model)
    h = cfg.n_heads
    return d_in, h, d_in // h


# ---------------------------------------------------------------------------
# mLSTM
# ---------------------------------------------------------------------------
def mlstm_defs(cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    d_in, h, dh = _mlstm_dims(cfg)
    return {
        "w_up": ParamDef((d, 2 * d_in), dtype=dt),
        "conv_w": ParamDef((d_in, _xc(cfg).conv_kernel), dtype=dt),
        "conv_b": ParamDef((d_in,), init="zeros", dtype=dt),
        # per-head block-diagonal q/k/v
        "w_q": ParamDef((h, dh, dh), dtype=dt, fan_in_axes=(1,)),
        "w_k": ParamDef((h, dh, dh), dtype=dt, fan_in_axes=(1,)),
        "w_v": ParamDef((h, dh, dh), dtype=dt, fan_in_axes=(1,)),
        "w_i": ParamDef((d_in, h), init="small", dtype="float32"),
        "w_f": ParamDef((d_in, h), init="small", dtype="float32"),
        "b_i": ParamDef((h,), init="zeros", dtype="float32"),
        "b_f": ParamDef((h,), init="ones", dtype="float32"),
        "out_norm": ParamDef((d_in,), init="ones", dtype=dt),
        "w_down": ParamDef((d_in, d), dtype=dt),
    }


def _mlstm_qkv(cfg: ModelConfig, p: dict, xc: torch.Tensor,
               xs: torch.Tensor):
    """Conv features ``xc`` (after SiLU) and the raw stream ``xs``, each
    (..., d_in) -> q, k, v (..., H, dh) and the gates (..., H) in f32: the
    log input gate and the log-sigmoid forget gate."""
    _, h, dh = _mlstm_dims(cfg)
    xch = xc.reshape(*xc.shape[:-1], h, dh)
    xsh = xs.reshape(*xs.shape[:-1], h, dh)
    q = torch.einsum("...hk,hkj->...hj", xch, p["w_q"])
    k = torch.einsum("...hk,hkj->...hj", xch, p["w_k"])
    v = torch.einsum("...hk,hkj->...hj", xsh, p["w_v"])
    x32 = xc.float()
    ig = torch.matmul(x32, p["w_i"]) + p["b_i"]
    fg = torch.nn.functional.logsigmoid(torch.matmul(x32, p["w_f"])
                                        + p["b_f"])
    return q, k, v, ig, fg


def _mlstm_pre(cfg: ModelConfig, p: dict, x: torch.Tensor,
               conv_hist: Optional[torch.Tensor] = None):
    """x: (B, S, D) -> q, k, v (B, S, H, dh), gates (B, S, H), z, and the
    conv's input stream (history ++ chunk: the source of the next chunk's
    conv history)."""
    xs, z = torch.matmul(x, p["w_up"]).chunk(2, dim=-1)
    if conv_hist is not None:
        ext = torch.cat([conv_hist, xs], dim=1)
        xc = causal_conv1d(ext, p["conv_w"],
                           p["conv_b"])[:, conv_hist.shape[1]:]
    else:
        ext = xs
        xc = causal_conv1d(xs, p["conv_w"], p["conv_b"])
    q, k, v, ig, fg = _mlstm_qkv(cfg, p, silu(xc), xs)
    return q, k, v, ig, fg, z, ext


def _mlstm_advance(qt, kt, vt, it, ft, c, n, m):
    """One stabilised step in f32 on a pre-scaled query: (B, H, dqk/dv)
    inputs, (B, H) gates.  Returns y (B, H, dv) and the new (c, n, m)."""
    fm = ft + m
    m_new = torch.maximum(fm, it)
    f_sc = torch.exp(fm - m_new)[..., None]
    ik = torch.exp(it - m_new)[..., None] * kt
    c = f_sc[..., None] * c + ik[..., None] * vt[:, :, None, :]
    n = f_sc * n + ik
    num = torch.einsum("bhd,bhdv->bhv", qt, c)
    den = torch.maximum(torch.abs(torch.einsum("bhd,bhd->bh", qt, n)),
                        torch.exp(-m_new))[..., None]
    return num / den, (c, n, m_new)


def mlstm_chunk_ref(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                    initial: Optional[tuple] = None):
    """The stabilised mLSTM over (B, S, H, D) q/k/v with (B, S, H)
    log-space gates, sequential over time (the port's copy of
    ``repro.kernels.ref.mlstm_chunk_ref``).  Without ``initial`` the state
    starts at zeros with ``m = -inf``.  Returns (y (B, S, H, dv) in q's
    dtype, (c, n, m))."""
    bsz, s, h, dqk = q.shape
    dv = v.shape[-1]
    if initial is None:
        c = torch.zeros((bsz, h, dqk, dv), dtype=torch.float32,
                        device=q.device)
        n = torch.zeros((bsz, h, dqk), dtype=torch.float32, device=q.device)
        m = torch.full((bsz, h), -torch.inf, dtype=torch.float32,
                       device=q.device)
    else:
        c, n, m = initial
    q32 = q.float() * dqk ** -0.5
    k32, v32 = k.float(), v.float()
    ig, fg = i_gate.float(), f_gate.float()
    ys = []
    for t in range(s):
        y, (c, n, m) = _mlstm_advance(q32[:, t], k32[:, t], v32[:, t],
                                      ig[:, t], fg[:, t], c, n, m)
        ys.append(y)
    y = torch.stack(ys, dim=1).to(q.dtype)
    return y, (c, n, m)


def mlstm_step_ref(q_t, k_t, v_t, i_t, f_t, state):
    """One step; (B, H, D*) / (B, H); state (c, n, m) (the port's copy of
    ``repro.kernels.ref.mlstm_step_ref``)."""
    c, n, m = state
    qt = q_t.float() * q_t.shape[-1] ** -0.5
    y, state = _mlstm_advance(qt, k_t.float(), v_t.float(), i_t.float(),
                              f_t.float(), c, n, m)
    return y.to(q_t.dtype), state


def mlstm_chunkwise(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                    i_gate: torch.Tensor, f_gate: torch.Tensor, *,
                    chunk: int = 64, initial: Optional[tuple] = None):
    """The chunkwise-parallel stabilised mLSTM (port of JAX's
    ``mlstm_chunkwise``): within a chunk of L tokens the interactions are
    causal (L x L) products, and the state is carried per chunk.  Per head,
    with b_j the inclusive cumulative log forget gate and G_j = max(m_0,
    cummax_k<=j(i_k - b_k)), every exponent is <= 0.  A given ``m`` is
    clamped to -1e30 (the sequential form's -inf would give NaNs).
    Returns what ``mlstm_chunk_ref`` returns, to ~1e-4."""
    bsz, s, h, dqk = q.shape
    dv = v.shape[-1]
    dev = q.device
    if initial is None:
        c0 = torch.zeros((bsz, h, dqk, dv), dtype=torch.float32, device=dev)
        n0 = torch.zeros((bsz, h, dqk), dtype=torch.float32, device=dev)
        m0 = torch.full((bsz, h), M_INIT, dtype=torch.float32, device=dev)
    else:
        c0, n0, m0 = initial
        m0 = torch.clamp(m0, min=M_INIT)
    ln = min(chunk, s)
    pad = (-s) % ln
    if pad:
        padt = lambda a, value=0.0: torch.nn.functional.pad(   # noqa: E731
            a, (0, 0) * (a.dim() - 2) + (0, pad), value=value)
        q, k, v, f_gate = padt(q), padt(k), padt(v), padt(f_gate)
        i_gate = padt(i_gate, M_INIT)             # no input on padding
    nc = (s + pad) // ln

    def chk(a, d):                                # (nc, B, H, L, d)
        return a.reshape(bsz, nc, ln, h, d).permute(1, 0, 3, 2, 4)

    qs = chk(q.float() * dqk ** -0.5, dqk)
    ks = chk(k.float(), dqk)
    vs = chk(v.float(), dv)
    igs = i_gate.float().reshape(bsz, nc, ln, h).permute(1, 0, 3, 2)
    fgs = f_gate.float().reshape(bsz, nc, ln, h).permute(1, 0, 3, 2)
    mask = torch.tril(torch.ones((ln, ln), dtype=torch.bool, device=dev))
    c, n, m = c0, n0, m0
    ys = []
    for j in range(nc):
        qc, kc, vc, ic, fc = qs[j], ks[j], vs[j], igs[j], fgs[j]
        b = torch.cumsum(fc, dim=-1)              # (B, H, L) inclusive
        a = ic - b
        g = torch.maximum(m[..., None], torch.cummax(a, dim=2).values)
        m_j = b + g
        w = torch.exp(a[..., None, :] - g[..., :, None])       # (B,H,Lj,Lk)
        w = torch.where(mask, w, 0.0)
        scores = torch.einsum("bhjd,bhkd->bhjk", qc, kc)
        carry = torch.exp(m[..., None] - g)[..., None]
        num = torch.einsum("bhjk,bhkv->bhjv", scores * w, vc) + \
            carry * torch.einsum("bhjd,bhdv->bhjv", qc, c)
        nvec = torch.einsum("bhjk,bhkd->bhjd", w, kc) + carry * n[..., None, :]
        den = torch.maximum(torch.abs(torch.einsum("bhjd,bhjd->bhj", qc,
                                                   nvec)),
                            torch.exp(-m_j))[..., None]
        ys.append(num / den)                      # (B, H, L, dv)
        g_l = g[..., -1]
        w_l = torch.exp(a - g_l[..., None])       # (B, H, L)
        c = torch.exp(m - g_l)[..., None, None] * c + \
            torch.einsum("bhk,bhkd,bhkv->bhdv", w_l, kc, vc)
        n = torch.exp(m - g_l)[..., None] * n + \
            torch.einsum("bhk,bhkd->bhd", w_l, kc)
        m = b[..., -1] + g_l
    y = torch.stack(ys).permute(1, 0, 3, 2, 4).reshape(bsz, nc * ln, h,
                                                         dv)[:, :s]
    return y.to(q.dtype), (c, n, m)


def _mlstm_out(cfg: ModelConfig, p: dict, y: torch.Tensor,
               z: torch.Tensor) -> torch.Tensor:
    """The output path: out-norm, the SiLU(z) gate and the down
    projection; y and z (..., d_in)."""
    return torch.matmul(rmsnorm(y, p["out_norm"], cfg.norm_eps) * silu(z),
                        p["w_down"])


def mlstm_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
               initial: Optional[dict] = None, return_state: bool = False):
    """Prefill or a chunk of it, resuming from ``initial`` when given.
    x: (B, S, D).  With ``return_state`` also the new state: the conv
    history is the tail of (history ++ chunk), so short chunks keep the
    earlier history."""
    d_in = _mlstm_dims(cfg)[0]
    hist = initial["conv"] if initial is not None else None
    st0 = (initial["c"], initial["n"], initial["m"]) \
        if initial is not None else None
    q, k, v, ig, fg, z, conv_src = _mlstm_pre(cfg, p, x, hist)
    y, (c, n, m) = mlstm_chunk_ref(q, k, v, ig, fg, initial=st0)
    b, s = x.shape[0], x.shape[1]
    out = _mlstm_out(cfg, p, y.reshape(b, s, d_in), z)
    if return_state:
        return out, {"conv": conv_tail(conv_src, _xc(cfg).conv_kernel - 1),
                     "c": c, "n": n, "m": m}
    return out


def mlstm_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict):
    """One token per row.  x: (B, 1, D).  Returns (out (B, 1, D), new
    state): new tensors, the cache left as it was."""
    d_in = _mlstm_dims(cfg)[0]
    xs, z = torch.matmul(x[:, 0], p["w_up"]).chunk(2, dim=-1)
    xc, conv_state = causal_conv1d_step(xs, cache["conv"], p["conv_w"],
                                        p["conv_b"])
    q, k, v, ig, fg = _mlstm_qkv(cfg, p, silu(xc), xs)
    y, (c, n, m) = mlstm_step_ref(q, k, v, ig, fg,
                                  (cache["c"], cache["n"], cache["m"]))
    out = _mlstm_out(cfg, p, y.reshape(x.shape[0], d_in), z)[:, None, :]
    return out, {"conv": conv_state, "c": c, "n": n, "m": m}


def _commit(leaf: torch.Tensor, s_i: torch.Tensor, act: torch.Tensor,
            new: torch.Tensor, old: torch.Tensor) -> None:
    """Write a token's new slot state into ``leaf`` in place, or its old
    one back for a padding token."""
    leaf.index_copy_(0, s_i, torch.where(act, new, old).to(leaf.dtype))


def mlstm_packed(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                 token_slot: torch.Tensor, token_active: torch.Tensor):
    """Token-packed step (DESIGN.md §8).  x: (1, T, D); cache: the whole
    slot-state arrays, updated in place.  As in JAX each token gathers its
    slot's state, advances it one step and commits it (active tokens
    only), so a segment's tokens chain through their slot.  The loop runs
    twice, first over the conv history, then over (c, n, m); between the
    two the projections that depend on no state (q, k, v, the gates and
    ``mlstm_step_ref``'s f32 casts and query scale) run once over the
    stream, where JAX computes them token by token.  Indices stay on the
    device: no sync."""
    d_in = _mlstm_dims(cfg)[0]
    xs, z = torch.matmul(x, p["w_up"]).chunk(2, dim=-1)   # (1, T, d_in)
    slots = token_slot.long()
    xc = conv_packed(cache["conv"], xs[0], p["conv_w"], p["conv_b"],
                     slots, token_active)
    q, k, v, ig, fg = _mlstm_qkv(cfg, p, silu(xc), xs[0])  # (T, H, *)
    q32 = q.float() * q.shape[-1] ** -0.5
    k32, v32 = k.float(), v.float()
    c_c, n_c, m_c = cache["c"], cache["n"], cache["m"]
    ys = []
    for t in range(xs.shape[1]):
        s_i, act = slots[t:t + 1], token_active[t]
        c0 = c_c.index_select(0, s_i)
        n0 = n_c.index_select(0, s_i)
        m0 = m_c.index_select(0, s_i)
        y_t, (c1, n1, m1) = _mlstm_advance(
            q32[t:t + 1], k32[t:t + 1], v32[t:t + 1], ig[t:t + 1],
            fg[t:t + 1], c0, n0, m0)
        _commit(c_c, s_i, act, c1, c0)
        _commit(n_c, s_i, act, n1, n0)
        _commit(m_c, s_i, act, m1, m0)
        ys.append(y_t[0])
    # y in q's dtype, then x's, as JAX rounds each step's output
    y = torch.stack(ys).reshape(1, -1, d_in).to(q.dtype).to(x.dtype)
    return _mlstm_out(cfg, p, y, z), cache


def mlstm_init_cache(cfg: ModelConfig, batch: int,
                     device: torch.device) -> dict:
    d_in, h, dh = _mlstm_dims(cfg)
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, _xc(cfg).conv_kernel - 1, d_in),
                                dtype=DTYPES[cfg.dtype], device=device),
            "c": torch.zeros((batch, h, dh, dh), **f32),
            "n": torch.zeros((batch, h, dh), **f32),
            "m": torch.full((batch, h), M_INIT, **f32)}


# ---------------------------------------------------------------------------
# sLSTM
# ---------------------------------------------------------------------------
def slstm_defs(cfg: ModelConfig) -> dict:
    d, dt = cfg.d_model, cfg.dtype
    h = cfg.n_heads
    dh = d // h
    f_d = 2 * d                                   # the post-FFN's GLU width
    return {
        "conv_w": ParamDef((d, _xc(cfg).slstm_conv_kernel), dtype=dt),
        "conv_b": ParamDef((d,), init="zeros", dtype=dt),
        "w_gates": ParamDef((d, 4 * d), dtype=dt),
        "r_gates": ParamDef((h, dh, 4 * dh), dtype=dt, fan_in_axes=(1,)),
        "b_gates": ParamDef((4 * d,), init="zeros", dtype="float32"),
        "out_norm": ParamDef((d,), init="ones", dtype=dt),
        "w_ffn_up": ParamDef((d, f_d), dtype=dt),
        "w_ffn_down": ParamDef((f_d // 2, d), dtype=dt),
    }


def _slstm_step(cfg: ModelConfig, p: dict, g_t: torch.Tensor, state: tuple):
    """One stabilised step with the block-diagonal recurrence.  g_t: (B,
    4D) input gate preactivations; state (c, n, h, m), each (B, D).
    Returns the new state; its h (in g_t's dtype) is the output."""
    c, n, hprev, m = state
    b, d, h = g_t.shape[0], cfg.d_model, cfg.n_heads
    rec = torch.einsum("bhd,hdk->bhk", hprev.reshape(b, h, d // h),
                       p["r_gates"]).reshape(b, 4 * d)
    pre = (g_t + rec).float() + p["b_gates"]
    i_p, f_p, z_p, o_p = pre.chunk(4, dim=-1)
    m_new = torch.maximum(f_p + m, i_p)
    i = torch.exp(i_p - m_new)
    f = torch.exp(f_p + m - m_new)
    c = f * c + i * torch.tanh(z_p)
    n = f * n + i
    h_new = (torch.sigmoid(o_p) * c / torch.clamp(n, min=1e-6)).to(g_t.dtype)
    return c, n, h_new, m_new


def _slstm_scan(cfg: ModelConfig, p: dict, xg: torch.Tensor, state: tuple):
    """xg: (B, S, 4D) gate preactivations (the input part).  The
    sequential recurrence; returns (outputs (B, S, D), final state)."""
    ys = []
    for t in range(xg.shape[1]):
        state = _slstm_step(cfg, p, xg[:, t], state)
        ys.append(state[2])
    return torch.stack(ys, dim=1), state


def _slstm_gates(cfg: ModelConfig, p: dict, xconv: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """The input part of the gate preactivations: the i and f gates see
    the conv features (after SiLU), z and o the raw input."""
    d2 = 2 * cfg.d_model
    return torch.cat([torch.matmul(silu(xconv), p["w_gates"][:, :d2]),
                      torch.matmul(x, p["w_gates"][:, d2:])], dim=-1)


def _slstm_out(cfg: ModelConfig, p: dict, ys: torch.Tensor) -> torch.Tensor:
    """The out-norm and the post up/down GLU FFN."""
    up = torch.matmul(rmsnorm(ys, p["out_norm"], cfg.norm_eps), p["w_ffn_up"])
    u, g = up.chunk(2, dim=-1)
    return torch.matmul(u * silu(g), p["w_ffn_down"])


def slstm_full(cfg: ModelConfig, p: dict, x: torch.Tensor,
               initial: Optional[dict] = None, return_state: bool = False):
    """Prefill or a chunk of it, resuming from ``initial`` when given.
    Without it the state starts at zeros with ``m = -1e30``."""
    if initial is not None:
        ext = torch.cat([initial["conv"], x], dim=1)
        xconv = causal_conv1d(ext, p["conv_w"], p["conv_b"])[
            :, initial["conv"].shape[1]:]
        state = (initial["c"], initial["n"], initial["h"], initial["m"])
    else:
        ext = x
        xconv = causal_conv1d(x, p["conv_w"], p["conv_b"])
        b, d = x.shape[0], cfg.d_model
        f32 = dict(dtype=torch.float32, device=x.device)
        state = (torch.zeros((b, d), **f32), torch.zeros((b, d), **f32),
                 torch.zeros((b, d), dtype=x.dtype, device=x.device),
                 torch.full((b, d), M_INIT, **f32))
    ys, (c, n, hs, m) = _slstm_scan(cfg, p, _slstm_gates(cfg, p, xconv, x),
                                    state)
    out = _slstm_out(cfg, p, ys)
    if return_state:
        return out, {"conv": conv_tail(ext, _xc(cfg).slstm_conv_kernel - 1),
                     "c": c, "n": n, "h": hs, "m": m}
    return out


def slstm_decode(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict):
    """One token per row.  x: (B, 1, D).  Returns (out (B, 1, D), new
    state): new tensors, the cache left as it was."""
    xt = x[:, 0]
    xconv, conv_state = causal_conv1d_step(xt, cache["conv"], p["conv_w"],
                                           p["conv_b"])
    c, n, hs, m = _slstm_step(cfg, p, _slstm_gates(cfg, p, xconv, xt),
                              (cache["c"], cache["n"], cache["h"],
                               cache["m"]))
    return _slstm_out(cfg, p, hs)[:, None, :], {
        "conv": conv_state, "c": c, "n": n, "h": hs, "m": m}


def slstm_packed(cfg: ModelConfig, p: dict, x: torch.Tensor, cache: dict,
                 token_slot: torch.Tensor, token_active: torch.Tensor):
    """Token-packed step (DESIGN.md §8), as ``mlstm_packed``: the conv
    loop, the gate projections over the stream, then the per-token loop
    over the slot's (c, n, h, m), committed for active tokens only; the
    out-norm and the GLU FFN run over the stream."""
    slots = token_slot.long()
    xconv = conv_packed(cache["conv"], x[0], p["conv_w"], p["conv_b"],
                         slots, token_active)
    xg = _slstm_gates(cfg, p, xconv, x[0])              # (T, 4D)
    leaves = [cache[k] for k in ("c", "n", "h", "m")]
    ys = []
    for t in range(xg.shape[0]):
        s_i, act = slots[t:t + 1], token_active[t]
        old = tuple(leaf.index_select(0, s_i) for leaf in leaves)
        new = _slstm_step(cfg, p, xg[t:t + 1], old)
        for leaf, n1, n0 in zip(leaves, new, old):
            _commit(leaf, s_i, act, n1, n0)
        ys.append(new[2][0])
    return _slstm_out(cfg, p, torch.stack(ys)[None]), cache


def slstm_init_cache(cfg: ModelConfig, batch: int,
                     device: torch.device) -> dict:
    d, dt = cfg.d_model, DTYPES[cfg.dtype]
    f32 = dict(dtype=torch.float32, device=device)
    return {"conv": torch.zeros((batch, _xc(cfg).slstm_conv_kernel - 1, d),
                                dtype=dt, device=device),
            "c": torch.zeros((batch, d), **f32),
            "n": torch.zeros((batch, d), **f32),
            "h": torch.zeros((batch, d), dtype=dt, device=device),
            "m": torch.full((batch, d), M_INIT, **f32)}
