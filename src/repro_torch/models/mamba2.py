"""Mamba-2 / SSD (state-space duality) block with the chunked scan, the JAX
package's formulation in PyTorch.

The block-decomposed SSD algorithm of Dao & Gu (arXiv:2405.21060): within a
chunk the output is a masked quadratic form; across chunks a small state
(H, P, N) is carried.  The JAX package carries it with ``lax.scan``; here a
Python loop over the chunks computes the same recurrence with the same
segment sums.  ``mamba_apply(..., state=...)`` also returns the final
state (the raw last ``d_conv - 1`` conv inputs and the SSD state), and
:func:`mamba_decode_step` advances it one token at a time.

Both also take a ``DTensor`` input (a sharded LM on a ``DeviceMesh``, the
parameters placed by the sharding rules: ``in_proj`` and the conv's
channels split over ``"model"``): the projection's output is gathered
once over the model axis, each rank runs the conv on its own channels
(those of its cache's ``conv`` state), the conv's output is gathered
once, and each rank runs the SSD, the gated norm and ``out_proj``'s rows
on its own heads (those of its cache's ``ssm`` state), the norm's mean
square summed over the axis (:class:`_Split`).  Every other op runs on
each rank's local tensors.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.models.layers import Params, _device_of, _local_as, dense_init, rows, tp_weight
from repro_torch.tree import is_dtensor

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


class _Whole:
    """The whole mixer in this process (a plain input): every hook is the
    identity, so the ops are the one-card ones."""

    size = 1

    def enter(self, t):
        return t

    def gather(self, t, dim):
        return t

    def sum(self, t):
        return t

    def param(self, p, heads=False):
        return p

    def take(self, t, dim, what):
        return t

    def out(self, t, dim):
        return t

    def local(self, t, dim):
        return t


class _Split:
    """One rank's part of the mixer on a ``DeviceMesh`` (``u`` a
    ``DTensor``): the batch stays split as ``u``'s is over the data axes;
    over ``"model"`` (``size`` ranks) this rank holds the conv channels
    and the heads of its index, contiguous and equal as ``Shard`` cuts
    them.  The hooks move tensors between ``DTensor`` placements and this
    rank's local tensors, and run the mixer's own collectives on those
    (:class:`_Gather`, :class:`_Sum`): a local tensor's gradient is whole
    on every rank that holds it, as a ``DTensor``'s placements promise."""

    def __init__(self, u, spec: MambaSpec):
        from torch.distributed.tensor import Replicate

        self.mesh = u.device_mesh
        self.m = self.mesh.mesh_dim_names.index("model")
        self.size = self.mesh.size(self.m)
        self.group = self.mesh.get_group(self.m)
        r = self.mesh.get_local_rank(self.m)
        conv_dim = spec.d_inner + 2 * spec.n_groups * spec.d_state
        for what, n in (("heads", spec.n_heads), ("conv channels", conv_dim)):
            if n % self.size:
                raise ValueError(f"{n} {what} do not split over a model axis of {self.size}")
        self.slices = {"heads": _chunk(spec.n_heads, self.size, r),
                       "di": _chunk(spec.d_inner, self.size, r),
                       "chans": _chunk(conv_dim, self.size, r)}
        self.batch = [Replicate() if i == self.m or not p.is_shard(0) else p
                      for i, p in enumerate(u.placements)]
        # a parameter's gradient sums over every axis that splits the batch
        self.batch_groups = [self.mesh.get_group(i) for i, p in enumerate(self.batch)
                             if p.is_shard()]

    def _pl(self, model):
        pl = list(self.batch)
        pl[self.m] = model
        return pl

    def enter(self, t):
        """A ``DTensor`` split over the model axis on its last dim -> this
        rank's rows of it, whole (one all-gather)."""
        return self.gather(self.local(t, -1), -1)

    def gather(self, t, dim):
        """This rank's shard along ``dim`` -> the whole (one all-gather)."""
        return _Gather.apply(t, self.group, dim % t.ndim)

    def sum(self, t):
        """Each rank's partial sum -> the sum over the model axis."""
        return _Sum.apply(t, [self.group], False)

    def param(self, p, heads=False):
        """A parameter's local shard (whole over the data axes), or with
        ``heads`` this rank's heads of a replicated (H,) one."""
        from torch.distributed.tensor import Replicate

        pl = [Replicate()] * self.mesh.ndim
        if not heads and is_dtensor(p):
            pl[self.m] = p.placements[self.m]
        groups = self.batch_groups + ([self.group] if heads else [])
        local = _Sum.apply(_local_as(p, self.mesh, pl), groups, True)
        return local[self.slices["heads"]] if heads else local

    def take(self, t, dim, what):
        """This rank's ``what`` (heads, di, chans) of a local tensor whole
        along ``dim``."""
        idx = [slice(None)] * t.ndim
        idx[dim] = self.slices[what]
        return t[tuple(idx)]

    def out(self, t, dim):
        """This rank's shard along ``dim`` as a ``DTensor`` split there over
        the model axis."""
        from torch.distributed.tensor import DTensor, Shard

        return DTensor.from_local(t, self.mesh, self._pl(Shard(dim % t.ndim)), run_check=False)

    def local(self, t, dim):
        """A ``DTensor`` (a state leaf, the projection) -> this rank's shard
        along ``dim``."""
        from torch.distributed.tensor import Shard

        return _local_as(t, self.mesh, self._pl(Shard(dim % t.ndim)))


class _Gather(torch.autograd.Function):
    """The ranks' tensors of ``group`` concatenated along ``dim`` in rank
    order; backward, each rank's own chunk of the gradient summed over the
    group (every rank used the whole in its own way)."""

    @staticmethod
    def forward(ctx, t, group, dim: int):
        import torch.distributed as dist

        ctx.group, ctx.dim = group, dim
        parts = [torch.empty_like(t, memory_format=torch.contiguous_format)
                 for _ in range(dist.get_world_size(group))]
        dist.all_gather(parts, t.contiguous(), group=group)
        return torch.cat(parts, dim=dim)

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        own = grad.chunk(dist.get_world_size(ctx.group), dim=ctx.dim)[dist.get_rank(ctx.group)]
        return own.contiguous(), None, None


class _Sum(torch.autograd.Function):
    """The sum over each group of ``groups`` (with ``grad_only``, the
    identity); backward, the gradient's sum over the same groups."""

    @staticmethod
    def forward(ctx, t, groups, grad_only: bool):
        import torch.distributed as dist

        ctx.groups = groups
        if grad_only or not groups:
            return t.view_as(t)
        out = t.clone(memory_format=torch.contiguous_format)
        for g in groups:
            dist.all_reduce(out, group=g)
        return out

    @staticmethod
    def backward(ctx, grad):
        import torch.distributed as dist

        if not ctx.groups:
            return grad, None, None
        grad = grad.clone(memory_format=torch.contiguous_format)
        for g in ctx.groups:
            dist.all_reduce(grad, group=g)
        return grad, None, None


def _chunk(n: int, parts: int, i: int) -> slice:
    return slice(i * n // parts, (i + 1) * n // parts)


_WHOLE = _Whole()


def _hooks(u, spec: MambaSpec):
    return _Split(u, spec) if is_dtensor(u) else _WHOLE


def _gated_rmsnorm(x, z, scale, eps=1e-6, sp=_WHOLE):
    """``x * silu(z)`` over its RMS, scaled by ``1 + scale``; on a split
    mixer the mean square sums every rank's ``d_inner`` shard."""
    dt = x.dtype
    g = x * F.silu(z)
    msq = sp.sum(torch.einsum("...d,...d->...", g.float(), g.float())) / (g.shape[-1] * sp.size)
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
    in ``u``'s dtype; a ``DTensor`` ``u`` gives them split over the model
    axis by channel and by head, and ``out`` owed a sum over it."""
    dt_ = u.dtype
    n, g, h, p = spec.d_state, spec.n_groups, spec.n_heads, spec.head_dim
    di = spec.d_inner
    sp = _hooks(u, spec)
    zxbcdt = sp.enter(rows(u) @ tp_weight(params["in_proj"]).to(dt_))
    bsz, seq, _ = zxbcdt.shape
    z, x, b, c, dt = _split_proj(zxbcdt, spec)

    # causal depthwise conv over (x, B, C), on this rank's channels
    xbc = torch.cat([x, b, c], dim=-1)  # (B, S, conv_dim)
    k = spec.d_conv
    xbc_pad = sp.take(F.pad(xbc, (0, 0, k - 1, 0)), 2, "chans")
    conv_w = sp.param(params["conv_w"]).to(dt_)
    conv = xbc_pad[:, 0:seq, :] * conv_w[0][None, None, :]
    for i in range(1, k):
        conv = conv + xbc_pad[:, i: i + seq, :] * conv_w[i][None, None, :]
    conv = sp.gather(F.silu(conv + sp.param(params["conv_b"]).to(dt_)), 2)
    x, b, c = conv[..., :di], conv[..., di: di + g * n], conv[..., di + g * n:]
    conv_state = None
    if state is not None:  # the raw last k-1 inputs, for decode
        conv_state = sp.out(xbc_pad[:, xbc_pad.shape[1] - (k - 1):, :].transpose(1, 2), 1)

    xh = sp.take(x.reshape(bsz, seq, h, p), 2, "heads")
    rep = h // g
    bh = sp.take(b.reshape(bsz, seq, g, n).repeat_interleave(rep, dim=2), 2, "heads")
    ch = sp.take(c.reshape(bsz, seq, g, n).repeat_interleave(rep, dim=2), 2, "heads")

    dt = _softplus(sp.take(dt, 2, "heads").float()
                   + sp.param(params["dt_bias"], heads=True)[None, None, :])
    a = -torch.exp(sp.param(params["A_log"], heads=True))  # (H,)
    da = dt * a[None, None, :]  # (B, S, H) log-decay per step

    y, final_ssm = _ssd_chunked(xh.float(), dt, da, bh.float(), ch.float(), chunk=spec.chunk)
    y = y + sp.param(params["D"], heads=True)[None, None, :, None] * xh.float()
    y = y.reshape(bsz, seq, -1).to(dt_)
    y = _gated_rmsnorm(y, sp.take(z, 2, "di"), sp.param(params["norm_scale"]), sp=sp)
    out = sp.out(y, 2) @ tp_weight(params["out_proj"]).to(dt_)
    if state is not None:
        return out, (conv_state, sp.out(final_ssm.to(dt_), 1))
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
    passed in is not written.  A ``DTensor`` ``u`` takes the state split
    over the model axis by channel and by head, as ``mamba_apply`` leaves
    it, and gives it back so."""
    dt_ = u.dtype
    n, g, h, p = spec.d_state, spec.n_groups, spec.n_heads, spec.head_dim
    di = spec.d_inner
    sp = _hooks(u, spec)
    conv_state, ssm_state = sp.local(state[0], 1), sp.local(state[1], 1)
    zxbcdt = sp.enter(rows(u[:, 0, :]) @ tp_weight(params["in_proj"]).to(dt_))
    bsz = zxbcdt.shape[0]
    z, x, b, c, dt = _split_proj(zxbcdt, spec)
    xbc = sp.take(torch.cat([x, b, c], dim=-1), 1, "chans")  # (B, conv_dim)
    # the conv over the window [state, new input], in the promoted dtype as
    # jnp's concatenate and einsum take it
    wdt = torch.promote_types(conv_state.dtype, dt_)
    window = torch.cat([conv_state.to(wdt), xbc[:, :, None].to(wdt)], dim=2)  # (B, cd, k)
    conv = F.silu(torch.einsum("bck,kc->bc", window, sp.param(params["conv_w"]).to(dt_).to(wdt))
                  + sp.param(params["conv_b"]).to(dt_).to(wdt))
    conv = sp.gather(conv, 1)
    x, b, c = conv[..., :di], conv[..., di: di + g * n], conv[..., di + g * n:]
    xh = sp.take(x.reshape(bsz, h, p), 1, "heads").float()
    rep = h // g
    # (B, H, N)
    bh = sp.take(b.reshape(bsz, g, n).repeat_interleave(rep, dim=1), 1, "heads").float()
    ch = sp.take(c.reshape(bsz, g, n).repeat_interleave(rep, dim=1), 1, "heads").float()
    dt = _softplus(sp.take(dt, 1, "heads").float()
                   + sp.param(params["dt_bias"], heads=True)[None, :])  # (B, H)
    dec = torch.exp(dt * -torch.exp(sp.param(params["A_log"], heads=True))[None, :])
    ssm = (ssm_state.float() * dec[:, :, None, None]
           + torch.einsum("bh,bhp,bhn->bhpn", dt, xh, bh))
    y = (torch.einsum("bhpn,bhn->bhp", ssm, ch)
         + sp.param(params["D"], heads=True)[None, :, None] * xh)
    y = _gated_rmsnorm(y.reshape(bsz, -1).to(dt_), sp.take(z, 1, "di"),
                       sp.param(params["norm_scale"]), sp=sp)
    out = (sp.out(y, 1) @ tp_weight(params["out_proj"]).to(dt_))[:, None, :]
    return out, (sp.out(window[:, :, 1:].to(dt_), 1), sp.out(ssm.to(dt_), 1))


def mamba_init_state(spec: MambaSpec, batch: int, dtype=torch.float32, device=None):
    """The zero decode state ``(conv (B, conv_dim, d_conv - 1), ssm (B, H,
    P, N))``."""
    conv_dim = spec.d_inner + 2 * spec.n_groups * spec.d_state
    return (torch.zeros((batch, conv_dim, spec.d_conv - 1), dtype=dtype, device=device),
            torch.zeros((batch, spec.n_heads, spec.head_dim, spec.d_state), dtype=dtype,
                        device=device))
