"""Mamba-2 / SSD (state-space duality) block with the chunked scan, the JAX
package's formulation in PyTorch.

The block-decomposed SSD algorithm of Dao & Gu (arXiv:2405.21060): within a
chunk the output is a masked quadratic form; across chunks a small state
(H, P, N) is carried.  The JAX package carries it with ``lax.scan``; here a
Python loop over the chunks computes the same recurrence with the same
segment sums.  ``mamba_apply(..., state=...)`` also returns the final
state (the raw last ``d_conv - 1`` conv inputs and the SSD state), and
:func:`mamba_decode_step` advances it one token at a time.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _device_of, dense_init

__all__ = ["MambaSpec", "mamba_apply", "mamba_decode_step", "mamba_init", "mamba_init_state"]


@dataclasses.dataclass(frozen=True)
class MambaSpec:
    d_model: int
    d_state: int = 128  # N
    d_conv: int = 4
    expand: int = 2
    head_dim: int = 64  # P
    n_groups: int = 1
    chunk: int = 256

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.head_dim


def mamba_init(generator: torch.Generator | None, spec: MambaSpec) -> dict:
    di, n, g, h = spec.d_inner, spec.d_state, spec.n_groups, spec.n_heads
    d_in_proj = 2 * di + 2 * g * n + h  # z, x, B, C, dt
    conv_dim = di + 2 * g * n
    dev = _device_of(generator)
    return {
        "in_proj": dense_init(generator, (spec.d_model, d_in_proj)),
        "conv_w": dense_init(generator, (spec.d_conv, conv_dim), in_axis=0),
        "conv_b": torch.zeros((conv_dim,), device=dev),
        "A_log": torch.log(torch.linspace(1.0, 16.0, h, device=dev)),  # A = -exp(A_log)
        "D": torch.ones((h,), device=dev),
        "dt_bias": torch.log(torch.exp(torch.linspace(1e-3, 1e-1, h, device=dev)) - 1.0),
        "norm_scale": torch.zeros((di,), device=dev),
        "out_proj": dense_init(generator, (di, spec.d_model)),
    }


def _split_proj(zxbcdt: torch.Tensor, spec: MambaSpec):
    di, n, g = spec.d_inner, spec.d_state, spec.n_groups
    z = zxbcdt[..., :di]
    x = zxbcdt[..., di: 2 * di]
    b = zxbcdt[..., 2 * di: 2 * di + g * n]
    c = zxbcdt[..., 2 * di + g * n: 2 * di + 2 * g * n]
    dt = zxbcdt[..., 2 * di + 2 * g * n:]
    return z, x, b, c, dt


def _gated_rmsnorm(x, z, scale, eps=1e-6):
    dt = x.dtype
    g = x * F.silu(z)
    msq = torch.einsum("...d,...d->...", g.float(), g.float()) / g.shape[-1]
    r = torch.rsqrt(msq + eps)[..., None].to(dt)
    return g * r * (1.0 + scale).to(dt)


def _softplus(x: torch.Tensor) -> torch.Tensor:
    # jax.nn.softplus is logaddexp(x, 0), with no linear cut-off
    return torch.logaddexp(x, torch.zeros_like(x))


def mamba_apply(params: Params, u: torch.Tensor, spec: MambaSpec, *, state=None):
    """Full-sequence chunked SSD, u (B, S, d_model) -> (out, final state or
    None).  As in the JAX package, the scan starts from a zero state and
    ``state`` only asks for the final one: ``(conv (B, conv_dim,
    d_conv - 1), ssm (B, H, P, N))``, the conv state the raw last
    ``d_conv - 1`` inputs (pad zeros where the sequence is shorter), both
    in ``u``'s dtype."""
    dt_ = u.dtype
    bsz, seq, _ = u.shape
    di, n, g, h, p = spec.d_inner, spec.d_state, spec.n_groups, spec.n_heads, spec.head_dim
    zxbcdt = u @ params["in_proj"].to(dt_)
    z, x, b, c, dt = _split_proj(zxbcdt, spec)

    # causal depthwise conv over (x, B, C)
    xbc = torch.cat([x, b, c], dim=-1)  # (B, S, conv_dim)
    k = spec.d_conv
    xbc_pad = F.pad(xbc, (0, 0, k - 1, 0))
    conv_w = params["conv_w"].to(dt_)
    conv = xbc_pad[:, 0:seq, :] * conv_w[0][None, None, :]
    for i in range(1, k):
        conv = conv + xbc_pad[:, i: i + seq, :] * conv_w[i][None, None, :]
    conv = F.silu(conv + params["conv_b"].to(dt_))
    x, b, c = conv[..., :di], conv[..., di: di + g * n], conv[..., di + g * n:]
    conv_state = None
    if state is not None:  # the raw last k-1 inputs, for decode
        conv_state = xbc_pad[:, xbc_pad.shape[1] - (k - 1):, :].transpose(1, 2)

    xh = x.reshape(bsz, seq, h, p)
    rep = h // g
    bh = b.reshape(bsz, seq, g, n).repeat_interleave(rep, dim=2)  # (B, S, H, N)
    ch = c.reshape(bsz, seq, g, n).repeat_interleave(rep, dim=2)

    dt = _softplus(dt.float() + params["dt_bias"][None, None, :])
    a = -torch.exp(params["A_log"])  # (H,)
    da = dt * a[None, None, :]  # (B, S, H) log-decay per step

    y, final_ssm = _ssd_chunked(xh.float(), dt, da, bh.float(), ch.float(), chunk=spec.chunk)
    y = y + params["D"][None, None, :, None] * xh.float()
    y = y.reshape(bsz, seq, di).to(dt_)
    y = _gated_rmsnorm(y, z, params["norm_scale"])
    out = y @ params["out_proj"].to(dt_)
    if state is not None:
        return out, (conv_state, final_ssm.to(dt_))
    return out, None


def _ssd_chunked(x, dt, da, b, c, *, chunk: int):
    """Block-decomposed SSD: x (B,S,H,P), dt/da (B,S,H), b/c (B,S,H,N) ->
    (y (B,S,H,P), final state (B,H,P,N)).  ``da`` is the per-step log
    decay: the state follows ``h_t = exp(da_t) h_{t-1} + dt_t * x_t b_t^T``.
    The padding to a multiple of the chunk has ``dt = da = 0``, so it
    leaves the state as it was."""
    bsz, seq, h, p = x.shape
    n = b.shape[-1]
    q = min(chunk, seq)
    pad = (-seq) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        da = F.pad(da, (0, 0, 0, pad))
        b = F.pad(b, (0, 0, 0, 0, 0, pad))
        c = F.pad(c, (0, 0, 0, 0, 0, pad))
    nc = (seq + pad) // q

    def rs(t):  # (B, S, ...) -> (nc, B, q, ...)
        return t.reshape(bsz, nc, q, *t.shape[2:]).transpose(0, 1)

    xc, dtc, dac, bc, cc = rs(x), rs(dt), rs(da), rs(b), rs(c)
    cum = torch.cumsum(dac, dim=2)  # (nc, B, q, H) within-chunk cumulative decay
    iq = torch.arange(q, device=x.device)
    causal = iq[:, None] >= iq[None, :]
    # inter-chunk recurrence over chunk-final states: the state entering
    # each chunk, from a zero state
    hprev = torch.zeros((bsz, h, p, n), device=x.device)
    ys = []
    for ci in range(nc):
        xq, dtq, daq, bq, cq, cumq = xc[ci], dtc[ci], dac[ci], bc[ci], cc[ci], cum[ci]
        # L[i, j] = exp(cum_i - cum_j) for i >= j (decay from j+1 to i).
        # Above the diagonal cum_i - cum_j > 0 can overflow exp to inf; the
        # JAX package masks after the exp, so its gradient there is 0 * inf
        # = NaN (at chunk 64 and up with its init).  Masking before the exp
        # gives the same values and a finite gradient.
        li = cumq[:, :, None, :] - cumq[:, None, :, :]  # (B, q, q, H)
        mask = causal[None, :, :, None]
        l = torch.where(mask, torch.exp(torch.where(mask, li, 0.0)), 0.0)
        s = torch.einsum("bihn,bjhn->bijh", cq, bq)  # C_i . B_j
        m = s * l * dtq[:, None, :, :]
        y_diag = torch.einsum("bijh,bjhp->bihp", m, xq)
        # chunk-final state: sum_j exp(cum_q - cum_j) dt_j x_j b_j^T
        w = torch.exp(cumq[:, -1:, :] - cumq) * dtq  # (B, q, H)
        st = torch.einsum("bjh,bjhp,bjhn->bhpn", w, xq, bq)
        # the entering state's contribution: y_i += C_i exp(cum_i) h_in
        y_state = torch.einsum("bihn,bhpn,bih->bihp", cq, hprev, torch.exp(cumq))
        ys.append(y_diag + y_state)
        hprev = hprev * torch.exp(daq.sum(dim=1))[:, :, None, None] + st
    y = torch.stack(ys).transpose(0, 1).reshape(bsz, seq + pad, h, p)
    return y[:, :seq], hprev


def mamba_decode_step(params: Params, u: torch.Tensor, spec: MambaSpec, state):
    """One token through the recurrence, O(1) in the sequence: u (B, 1,
    d_model), ``state = (conv (B, conv_dim, d_conv - 1), ssm (B, H, P, N))``
    -> (out (B, 1, d_model), the new state in ``u``'s dtype); the state
    passed in is not written."""
    dt_ = u.dtype
    bsz = u.shape[0]
    di, n, g, h, p = spec.d_inner, spec.d_state, spec.n_groups, spec.n_heads, spec.head_dim
    conv_state, ssm_state = state
    z, x, b, c, dt = _split_proj(u[:, 0, :] @ params["in_proj"].to(dt_), spec)
    xbc = torch.cat([x, b, c], dim=-1)  # (B, conv_dim)
    # the conv over the window [state, new input], in the promoted dtype as
    # jnp's concatenate and einsum take it
    wdt = torch.promote_types(conv_state.dtype, dt_)
    window = torch.cat([conv_state.to(wdt), xbc[:, :, None].to(wdt)], dim=2)  # (B, cd, k)
    conv = F.silu(torch.einsum("bck,kc->bc", window, params["conv_w"].to(dt_).to(wdt))
                  + params["conv_b"].to(dt_).to(wdt))
    x, b, c = conv[..., :di], conv[..., di: di + g * n], conv[..., di + g * n:]
    xh = x.reshape(bsz, h, p).float()
    rep = h // g
    bh = b.reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()  # (B, H, N)
    ch = c.reshape(bsz, g, n).repeat_interleave(rep, dim=1).float()
    dt = _softplus(dt.float() + params["dt_bias"][None, :])  # (B, H)
    dec = torch.exp(dt * -torch.exp(params["A_log"])[None, :])
    ssm = (ssm_state.float() * dec[:, :, None, None]
           + torch.einsum("bh,bhp,bhn->bhpn", dt, xh, bh))
    y = torch.einsum("bhpn,bhn->bhp", ssm, ch) + params["D"][None, :, None] * xh
    y = _gated_rmsnorm(y.reshape(bsz, di).to(dt_), z, params["norm_scale"])
    out = (y @ params["out_proj"].to(dt_))[:, None, :]
    return out, (window[:, :, 1:].to(dt_), ssm.to(dt_))


def mamba_init_state(spec: MambaSpec, batch: int, dtype=torch.float32, device=None):
    """The zero decode state ``(conv (B, conv_dim, d_conv - 1), ssm (B, H,
    P, N))``."""
    conv_dim = spec.d_inner + 2 * spec.n_groups * spec.d_state
    return (torch.zeros((batch, conv_dim, spec.d_conv - 1), dtype=dtype, device=device),
            torch.zeros((batch, spec.n_heads, spec.head_dim, spec.d_state), dtype=dtype,
                        device=device))
