"""Iteration history recording + console progress table.

Port of onephase_tpu/ipm/history.py: the same 32 metrics per inner
iteration, written into a fixed-capacity ring of shape (B, cap, NCOLS)
inside the chunk loop; decoding and printing happen on the host between
chunks.
"""

from __future__ import annotations

import numpy as np
import torch

# column order (alg_history2 fields, display_progress.jl:7-42)
COLUMNS = [
    "t", "step_type", "eta_P", "eta_D", "eta_mu",
    "ls_num_steps", "alpha_P", "alpha_D",
    "dir_x_norm", "dir_y_norm", "dir_s_norm", "kkt_ratio",
    "mu", "fval", "dual_scaled", "norm_grad_lag",
    "primal_residual", "con_vio", "comp", "sy_inf", "comp_ratio", "sy_mean",
    "farkas", "delta", "merit", "phi", "grad_phi_norm",
    "y_norm", "x_norm", "tot_num_fac", "num_fac_inertia", "strict_comp",
]
NCOLS = len(COLUMNS)
IDX = {c: i for i, c in enumerate(COLUMNS)}


def _amax(v):
    return v.amax(dim=-1)


def record(kernel, st, step_type):
    """Compute the 32 metrics at the current state and append them to every
    instance's ring.  `step_type` is a Python int or a (B,) tensor."""
    p, cache = st.p, st.cache
    mu = p.mu
    sy = p.s * p.y
    comp = sy - mu[:, None]
    comp_inf = _amax(comp.abs())
    grad_lag = kernel.grad_lag(cache, p.y, mu)
    gl_inf = _amax(grad_lag.abs())
    scale = kernel.dual_scale(p.y, p.s)
    jt_y_1 = cache.jt_y.abs().sum(-1)
    feas_obj = -(cache.a * p.y).sum(-1)
    inf = torch.full_like(feas_obj, float("inf"))
    fark1 = torch.where(feas_obj > 0.0, jt_y_1 / feas_obj, inf)
    fark2 = (jt_y_1 + (p.s * p.y).sum(-1)) / p.y.abs().sum(-1)
    phi = kernel.eval_phi(p, cache, mu)
    # grad phi = grad_lag with y_tilde = mu/s
    jt_mus = kernel.nlp.jtprod(p.x, mu[:, None] / p.s, st.pdata)
    gphi = cache.g - jt_mus + (mu * kernel.pars.a_norm_penalty)[:, None] * cache.jt_ones
    s_n = _amax(p.s.abs())
    y_n = _amax(p.y.abs())
    strict = _amax(torch.minimum(p.s / s_n[:, None], p.y / y_n[:, None]))
    dt = p.x.dtype
    stype = torch.as_tensor(step_type, device=p.x.device).to(dt).expand_as(mu)

    row = torch.stack([
        st.t.to(dt), stype,
        st.eta[:, 0], st.eta[:, 1], st.eta[:, 2],
        st.ls.num_steps.to(dt), st.ls.alpha_P, st.ls.alpha_D,
        _amax(st.dir.x.abs()), _amax(st.dir.y.abs()),
        _amax(st.dir.s.abs()), st.kkt_ratio,
        mu, cache.fval, gl_inf * scale, gl_inf,
        _amax((cache.a - p.s).abs()),
        -torch.clamp(cache.a.amin(-1), max=0.0),
        comp_inf, _amax(sy),
        torch.maximum(_amax(sy / mu[:, None]), _amax(mu[:, None] / sy)),
        sy.mean(-1),
        torch.maximum(fark1, fark2), st.delta,
        kernel.eval_merit(p, cache), phi, _amax(gphi.abs()),
        y_n, _amax(p.x.abs()),
        st.tot_num_fac.to(dt), st.num_fac_inertia.to(dt), strict,
    ], dim=-1)                                            # (B, NCOLS)
    h = st.hist
    cap = h.buf.shape[1]
    i = torch.clamp(h.count, max=cap - 1)
    slot = torch.arange(cap, device=i.device)[None, :] == i[:, None].long()
    buf = torch.where(slot[:, :, None], row[:, None, :], h.buf)
    return h._replace(buf=buf, count=torch.clamp(h.count + 1, max=cap))


# ---------------------------------------------------------------------------
# host-side decoding / printing
# ---------------------------------------------------------------------------
STEP_NAMES = {0: "it0", 1: "agg", 2: "stb"}

HEADER = ("  it step    eta_mu    α_P      α_D    ls    |dx|     |dy|    N err"
          " |    mu      dual    primal   cmp scl  infeas? |  delta   #fac"
          "   |x|     |y|")


def rows_to_records(buf: np.ndarray, count: int):
    """Convert one instance's ring buffer (cap, NCOLS) to dict records."""
    out = []
    for i in range(int(count)):
        row = buf[i]
        rec = {c: float(row[j]) for j, c in enumerate(COLUMNS)}
        rec["t"] = int(rec["t"])
        rec["step_type"] = STEP_NAMES.get(int(rec["step_type"]), "?")
        rec["ls_num_steps"] = int(rec["ls_num_steps"])
        rec["tot_num_fac"] = int(rec["tot_num_fac"])
        rec["num_fac_inertia"] = int(rec["num_fac_inertia"])
        out.append(rec)
    return out


def _rd(v):
    if not np.isfinite(v):
        return f"{str(v):>9}"
    return f"{v:9.1e}"


def format_row(r, scale) -> str:
    comp_scaled = r["sy_inf"] * scale
    return (f"{r['t']:4d} {r['step_type']:<4s}{_rd(r['eta_mu'])}"
            f"{_rd(r['alpha_P'])}{_rd(r['alpha_D'])} {r['ls_num_steps']:3d}"
            f"{_rd(r['dir_x_norm'])}{_rd(r['dir_y_norm'])}{_rd(r['kkt_ratio'])}"
            f" |{_rd(r['mu'])}{_rd(r['dual_scaled'])}{_rd(r['primal_residual'])}"
            f"{_rd(comp_scaled)}{_rd(r['farkas'])}"
            f" |{_rd(r['delta'])} {r['tot_num_fac']:4d}"
            f"{_rd(r['x_norm'])}{_rd(r['y_norm'])}")
