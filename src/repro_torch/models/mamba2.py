"""Mamba2 (state-space duality / SSD) mixer block (counterpart of
``repro.models.mamba2``).

The chunked SSD for prefill and full sequences (the reference's
``lax.scan`` over chunks is a loop over chunks here), and the O(1)-state
single-step recurrence for decode.  The SSD runs in float32 whatever the
activations' dtype, as in the reference.  Its intra-chunk decay matrix is
masked before the exponential, so its gradients stay finite where the
reference's turn to nan (ROADMAP.md queue 3).  The jamba hybrid uses this
same block (DESIGN.md §9: Mamba-1 -> Mamba2 substitution).
"""
from __future__ import annotations

from typing import Optional

import torch
from torch import nn
from torch.nn import functional as F

from .layers import normal, param


class Mamba2(nn.Module):
    """Projections ``in_z`` / ``in_x`` (R, d, d_in), ``in_B`` / ``in_C``
    (R, d, G N), ``in_dt`` (R, d, H); depthwise conv weights ``conv_x`` /
    ``conv_B`` / ``conv_C`` (R, K, channels); per-head ``A_log``, ``D``,
    ``dt_bias`` (R, H); the gated norm's ``norm`` (R, d_in); ``out``
    (R, d_in, d)."""

    SPECS = {"in_z": ("embed", "mamba_inner"),
             "in_x": ("embed", "mamba_inner"),
             "in_B": ("embed", None),
             "in_C": ("embed", None),
             "in_dt": ("embed", "mamba_heads"),
             "conv_x": (None, "mamba_inner"),
             "conv_B": (None, None),
             "conv_C": (None, None),
             "A_log": ("mamba_heads",),
             "D": ("mamba_heads",),
             "dt_bias": ("mamba_heads",),
             "norm": ("mamba_inner",),
             "out": ("mamba_inner", "embed")}

    def __init__(self, cfg, repeats: int, gen: Optional[torch.Generator],
                 device=None):
        super().__init__()
        m, d = cfg.mamba, cfg.d_model
        d_in = m.expand * d
        H = d_in // m.head_dim
        gn = m.n_groups * m.d_state
        s = d ** -0.5
        R = repeats
        drawn = (("in_z", (d, d_in), s), ("in_x", (d, d_in), s),
                 ("in_B", (d, gn), s), ("in_C", (d, gn), s),
                 ("in_dt", (d, H), s),
                 ("conv_x", (m.conv_width, d_in), 0.1),
                 ("conv_B", (m.conv_width, gn), 0.1),
                 ("conv_C", (m.conv_width, gn), 0.1),
                 ("out", (d_in, d), d_in ** -0.5))
        for name, shape, sc in drawn:
            t = (normal((R,) + shape, sc, gen, device) if gen is not None
                 else torch.empty((R,) + shape, device=device))
            setattr(self, name, param(t))
        a_log = torch.log(torch.linspace(1.0, 16.0, H, device=device))
        self.A_log = param(a_log.expand(R, H).clone())
        self.D = param(torch.ones((R, H), device=device))
        self.dt_bias = param(torch.zeros((R, H), device=device))
        self.norm = param(torch.ones((R, d_in), device=device))


def _causal_conv(x: torch.Tensor, w: torch.Tensor,
                 state: Optional[torch.Tensor]):
    """Depthwise causal conv.  x: (B, L, C), w: (K, C), state: (B, K-1, C)
    trailing context or None (zero history).  Returns (y, new_state)."""
    B, L, C = x.shape
    K = w.shape[0]
    if state is None:
        state = torch.zeros((B, K - 1, C), dtype=x.dtype, device=x.device)
    dt = torch.promote_types(state.dtype, x.dtype)
    xp = torch.cat([state.to(dt), x.to(dt)], dim=1)   # (B, K-1+L, C)
    y = sum(xp[:, i:i + L, :] * w[i] for i in range(K))
    new_state = xp[:, L:, :] if K > 1 else state
    return y, new_state


def _ssd_chunked(xh, dt, A, Bm, Cm, chunk: int, h0: Optional[torch.Tensor]):
    """Chunked SSD.  xh: (B,L,H,P), dt: (B,L,H), A: (H,), Bm/Cm: (B,L,G,N).
    Returns (y (B,L,H,P), h_final (B,H,P,N))."""
    B, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    Q = min(chunk, L)
    while L % Q:
        Q -= 1
    nc = L // Q

    Bh = torch.repeat_interleave(Bm, hpg, dim=2)                # (B,L,H,N)
    Ch = torch.repeat_interleave(Cm, hpg, dim=2)
    a = dt * A                                                  # (B, L, H)
    xr = xh.reshape(B, nc, Q, H, P)
    dtr = dt.reshape(B, nc, Q, H)
    ar = a.reshape(B, nc, Q, H)
    Br = Bh.reshape(B, nc, Q, H, N)
    Cr = Ch.reshape(B, nc, Q, H, N)
    acs = torch.cumsum(ar, dim=2)                               # (B,nc,Q,H)

    # intra-chunk (diagonal) term
    seg = acs[:, :, :, None, :] - acs[:, :, None, :, :]         # (B,nc,Qi,Qj,H)
    tri = torch.tril(torch.ones((Q, Q), dtype=torch.bool, device=xh.device))
    # masked before the exponential: above the diagonal seg is a positive
    # sum of |dt A| that overflows exp to inf within a chunk, and a where
    # after the exp would send 0 * inf = nan back through it (the
    # reference's where(tri, exp(seg), 0) does); exp(-inf) = 0 gives the
    # same forward values
    M = torch.exp(torch.where(tri[None, None, :, :, None], seg,
                              float("-inf")))
    CB = torch.einsum("bcihn,bcjhn->bcijh", Cr, Br)             # (B,nc,Q,Q,H)
    xdt = xr * dtr[..., None]
    y_diag = torch.einsum("bcijh,bcjhp->bcihp", CB * M, xdt)

    # per-chunk input -> state contribution
    decay_to_end = torch.exp(acs[:, :, -1:, :] - acs)           # (B,nc,Q,H)
    states = torch.einsum("bcjhn,bcjhp->bchpn",
                          Br * (decay_to_end * dtr)[..., None], xr)
    chunk_decay = torch.exp(acs[:, :, -1, :])                   # (B,nc,H)

    # inter-chunk recurrence: the state entering each chunk
    h = (torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
         if h0 is None else h0)
    entering = []
    for c in range(nc):
        entering.append(h)
        h = h * chunk_decay[:, c, :, None, None] + states[:, c]
    h_enter = torch.stack(entering, dim=1)                      # (B,nc,H,P,N)
    y_off = (torch.einsum("bcihn,bchpn->bcihp", Cr, h_enter)
             * torch.exp(acs)[..., None])

    y = (y_diag + y_off).reshape(B, L, H, P)
    return y, h


def _ssd_steps(xh, dt, A, Bm, Cm, h: Optional[torch.Tensor]):
    """The single-step recurrence over L steps (decode: L = 1).  Shapes as
    ``_ssd_chunked``."""
    B, L, H, P = xh.shape
    G, N = Bm.shape[2], Bm.shape[3]
    hpg = H // G
    if h is None:
        h = torch.zeros((B, H, P, N), dtype=torch.float32, device=xh.device)
    ys = []
    for t in range(L):
        Bt = torch.repeat_interleave(Bm[:, t], hpg, dim=1)      # (B,H,N)
        Ct = torch.repeat_interleave(Cm[:, t], hpg, dim=1)
        dtt = dt[:, t]
        da = torch.exp(dtt * A)                                 # (B,H)
        h = h * da[:, :, None, None] + torch.einsum(
            "bhp,bhn->bhpn", xh[:, t] * dtt[..., None], Bt)
        ys.append(torch.einsum("bhn,bhpn->bhp", Ct, h))
    return torch.stack(ys, dim=1), h


def mamba_apply(p: Mamba2, r: int, cfg, x: torch.Tensor, *,
                state: Optional[dict] = None) -> torch.Tensor:
    """Repeat ``r``.  x: (B, L, d).  ``state``: {"conv_x", "conv_B",
    "conv_C", "ssm"} views of the stacked caches, updated in place (a
    serving path, under ``torch.no_grad()``), or None (training and
    scoring)."""
    m = cfg.mamba
    B, L, d = x.shape
    d_in = m.expand * d
    H = d_in // m.head_dim
    P = m.head_dim
    G, N = m.n_groups, m.d_state

    z = x @ p.in_z[r]
    xs = x @ p.in_x[r]
    Bm = x @ p.in_B[r]
    Cm = x @ p.in_C[r]
    dt = F.softplus(x @ p.in_dt[r] + p.dt_bias[r])              # (B,L,H)

    st = state or {}
    xs, cs_x = _causal_conv(xs, p.conv_x[r], st.get("conv_x"))
    Bm, cs_B = _causal_conv(Bm, p.conv_B[r], st.get("conv_B"))
    Cm, cs_C = _causal_conv(Cm, p.conv_C[r], st.get("conv_C"))
    xs, Bm, Cm = F.silu(xs), F.silu(Bm), F.silu(Cm)

    A = -torch.exp(p.A_log[r])                                  # (H,)
    xh = xs.reshape(B, L, H, P).float()
    Bh = Bm.reshape(B, L, G, N).float()
    Ch = Cm.reshape(B, L, G, N).float()
    dtf = dt.float()

    if L > 1:
        # chunked SSD for prefill and full sequences (from the incoming
        # state, if any)
        y, h_final = _ssd_chunked(xh, dtf, A, Bh, Ch, m.chunk, st.get("ssm"))
    else:
        y, h_final = _ssd_steps(xh, dtf, A, Bh, Ch, st.get("ssm"))

    y = y + xh * p.D[r][:, None]
    y = y.reshape(B, L, d_in).to(x.dtype)
    # gated RMSNorm, then the output projection
    y = y * F.silu(z)
    yf = y.float()
    y = (yf * torch.rsqrt(torch.mean(yf * yf, -1, keepdim=True)
                          + cfg.norm_eps) * p.norm[r]).to(x.dtype)
    out = y @ p.out[r]
    if state is not None:
        for name, new in (("conv_x", cs_x), ("conv_B", cs_B),
                          ("conv_C", cs_C), ("ssm", h_final)):
            state[name].copy_(new)
    return out
