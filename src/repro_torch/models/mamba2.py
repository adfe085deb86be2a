"""Mamba-2 (SSD, state-space duality) mixer in its chunked-parallel form
(twin of ``repro.models.mamba2``), in plain torch ops: the reference has no
Pallas kernel here, and its projections are StruM linears
(:func:`repro_torch.models.layers.linear`, so packed ``in_proj`` /
``out_proj`` run the engine's kernels).

Scalar-identity A per head, one B/C group, a depthwise causal conv over
(x, B, C), Δ by softplus, the D skip, a gated RMSNorm and ``out_proj``.
Within a chunk the token mixing is a masked (C Bᵀ ⊙ decay) product; across
chunks a (B, heads, head_dim, state) f32 state is carried.  The reference's
``lax.scan`` over chunks is a Python loop here; every tensor of a chunk step
is O(B·c·c·nh), as in the reference.  Each three-operand einsum of the
reference is two products here, the first of them elementwise, so no
(B, c, c, nh, hp) tensor is formed.

Decode is the O(1) recurrent step on the carried (conv, state) cache.
Casts follow the reference: the conv output goes back to the activation
dtype before the scan, y goes to it before the ``silu(z)`` gate, the conv
cache is kept in the activation dtype and the state in f32.

In the sharded serving layout (``spmd=True`` with a ``tp_mesh`` among the
linears' keywords; :mod:`repro_torch.models.sharding`) ``ssm_apply`` and
``ssm_decode`` take the reference's blocks: this rank's rows, the
``in_proj`` / ``conv`` / ``norm_scale`` columns, the heads and the caches
over ``model``.  The ``model`` blocks of ``in_proj`` (z | x | B | C | dt)
and of the conv channels (x | B | C) do not line up with the heads, so:
``in_proj`` runs column-parallel and its output is gathered over
``model``; the depthwise conv runs on this rank's channel block against
its ``conv`` cache block and its output is gathered over ``model``; the
scan takes this rank's heads of x, dt and the state and all of B and C;
the gated RMSNorm all-reduces its sum of squares over ``model``; and
``out_proj`` is row-parallel on the heads' block of ``d_inner``.  With
``ssm_split_proj`` z and dt arrive as the heads' blocks, x and B / C are
gathered whole.  The heads and the conv channels must divide over
``model``.  The train layout (``launch.steps.make_train_step`` on a mesh)
runs ``ssm_apply`` on the same blocks under autograd: the input of the
column-parallel projections passes ``layers.tp_input``, each gather's
backward sums the parts of the gradient the ranks' heads give it (and so
does ``in_bc``'s, whole on every rank), and the norm's sum of squares is
``sharding.shared_all_reduce``, whose backward sums too.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F

from repro_torch.models import sharding as shd
from repro_torch.models.layers import linear, linear_def, rms_norm, tp_input
from repro_torch.models.params import ParamDef

__all__ = ["ssm_def", "ssm_apply", "ssm_decode", "ssm_prefill_chunk",
           "ssm_cache_spec"]

_F32 = torch.float32


def _dims(cfg):
    di = cfg.d_inner
    nh = cfg.ssm_heads
    hp = cfg.ssm_head_dim
    ns = cfg.ssm_state
    conv_dim = di + 2 * ns          # the conv runs over (x, B, C)
    return di, nh, hp, ns, conv_dim


def ssm_def(cfg, lead=()) -> dict:
    """One fused ``in_proj`` (z, x, B, C, dt), or with ``cfg.ssm_split_proj``
    four projections ``in_z``, ``in_x``, ``in_bc``, ``in_dt``."""
    d = cfg.d_model
    di, nh, hp, ns, conv_dim = _dims(cfg)
    if cfg.ssm_split_proj:
        return {
            "in_z": linear_def(d, di, "embed", "ssm_inner", lead=lead),
            "in_x": linear_def(d, di, "embed", "ssm_inner", lead=lead),
            "in_bc": linear_def(d, 2 * ns, "embed", "ssm_state", lead=lead),
            "in_dt": linear_def(d, nh, "embed", "ssm_heads", lead=lead),
            **_ssm_def_tail(cfg, lead),
        }
    proj_out = 2 * di + 2 * ns + nh
    return {"in_proj": linear_def(d, proj_out, "embed", "ssm_inner", lead=lead),
            **_ssm_def_tail(cfg, lead)}


def _ssm_def_tail(cfg, lead):
    d = cfg.d_model
    di, nh, hp, ns, conv_dim = _dims(cfg)
    la = ("layers",) * len(lead)
    return {
        "conv_w": ParamDef(lead + (cfg.ssm_conv, conv_dim),
                           la + ("conv", "ssm_inner"), scale=0.5),
        "conv_b": ParamDef(lead + (conv_dim,), la + ("ssm_inner",), init="zeros"),
        "a_log": ParamDef(lead + (nh,), la + ("ssm_heads",), init="zeros"),
        "d_skip": ParamDef(lead + (nh,), la + ("ssm_heads",), init="ones"),
        "dt_bias": ParamDef(lead + (nh,), la + ("ssm_heads",), init="zeros"),
        "norm_scale": ParamDef(lead + (di,), la + ("ssm_inner",), init="ones"),
        "out_proj": linear_def(di, d, "ssm_inner", "embed", lead=lead),
    }


def _split_proj(zxbcdt, cfg):
    di, nh, hp, ns, _ = _dims(cfg)
    return (zxbcdt[..., :di], zxbcdt[..., di:2 * di],
            zxbcdt[..., 2 * di:2 * di + ns], zxbcdt[..., 2 * di + ns:2 * di + 2 * ns],
            zxbcdt[..., 2 * di + 2 * ns:])


def _conv_seq(xbc, w, bias):
    """Causal depthwise conv over the sequence.  xbc: (B, S, C); w: (W, C)."""
    width = w.shape[0]
    pad = F.pad(xbc, (0, 0, width - 1, 0))
    out = sum(pad[:, i:i + xbc.shape[1], :] * w[i][None, None, :]
              for i in range(width))
    return F.silu(out + bias[None, None, :])


def _segment_decay(seg: torch.Tensor, tril: torch.Tensor) -> torch.Tensor:
    """``exp(seg)`` on and below the diagonal, 0 above.  seg (B,t,s,nh) is
    positive above the diagonal, where exp can overflow: seg is masked to
    -inf before exp (exp(-inf) = 0), so no inf enters the forward and no
    0 · inf the gradient of seg.  The same values as selecting after exp."""
    return torch.exp(torch.where(tril[None, :, :, None], seg,
                                 torch.full((), -torch.inf, dtype=seg.dtype,
                                            device=seg.device)))


def _ssd_chunked(xh, dt, a, bb, cc, chunk: int, h0=None):
    """Chunked SSD scan.

    xh (B,S,nh,hp)  dt (B,S,nh) >= 0  a (nh,) < 0  bb/cc (B,S,ns).
    Returns y (B,S,nh,hp) f32 and the final state (B,nh,hp,ns) f32.
    """
    b, s, nh, hp = xh.shape
    ns = bb.shape[-1]
    c = min(chunk, s)
    pad = (-s) % c
    if pad:  # ragged tail: dt = 0 rows are exact no-ops (decay 1, input 0)
        xh = F.pad(xh, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        bb = F.pad(bb, (0, 0, 0, pad))
        cc = F.pad(cc, (0, 0, 0, pad))
        s = s + pad
    da = dt * a[None, None, :]                              # (B,S,nh) (< 0)
    xdt = xh.to(_F32) * dt[..., None]                       # Δ·x
    bf, cf = bb.to(_F32), cc.to(_F32)
    tril = torch.ones((c, c), dtype=torch.bool, device=xh.device).tril()
    h = (torch.zeros((b, nh, hp, ns), dtype=_F32, device=xh.device)
         if h0 is None else h0.to(_F32))
    ys = []
    for j in range(s // c):
        sl = slice(j * c, (j + 1) * c)
        dak, xdtk, bk, ck = da[:, sl], xdt[:, sl], bf[:, sl], cf[:, sl]
        cum = torch.cumsum(dak, dim=1)                      # (B,c,nh)
        seg = cum[:, :, None, :] - cum[:, None, :, :]       # (B,t,s,nh)
        decay = _segment_decay(seg, tril)
        scores = torch.einsum("btk,bsk->bts", ck, bk)       # (B,t,s)
        y_intra = torch.einsum("btsh,bshp->bthp", scores[..., None] * decay, xdtk)
        # inter-chunk: y[t] += C_t · h_prev · exp(cum[t])
        y_inter = torch.einsum("btk,bhpk->bthp", ck, h) * torch.exp(cum)[..., None]
        # state: h = h·exp(cum[-1]) + Σ_s exp(cum[-1] - cum[s]) B_s (Δx)_s
        tail = torch.exp(cum[:, -1:, :] - cum)              # (B,c,nh)
        st_in = torch.einsum("bsk,bshp->bhpk", bk, xdtk * tail[..., None])
        h = h * torch.exp(cum[:, -1, :])[:, :, None, None] + st_in
        ys.append(y_intra + y_inter)
    y = torch.cat(ys, dim=1)
    if pad:
        y = y[:, :s - pad]
    return y, h


def _tp_blocks(cfg, kw):
    """``(mesh, heads, channels)`` of the sharded serving layout: its mesh
    and this rank's slices of the heads and of the conv channels over
    ``model``; ``(None, all heads, all channels)`` in any other lane."""
    di, nh, hp, ns, conv_dim = _dims(cfg)
    mesh = kw.get("tp_mesh") if kw.get("spmd") else None
    tp = shd.tp_axis(mesh) if mesh is not None else None
    n = shd.axis_size(mesh, tp)
    if n == 1:
        return mesh, slice(0, nh), slice(0, conv_dim)
    if nh % n or conv_dim % n:
        raise ValueError(
            f"sharded serving layout: {nh} SSM heads and {conv_dim} conv channels "
            f"do not both divide over the 'model' axis of {n} ranks")
    r = shd.axis_index(mesh, tp)
    return (mesh, slice(r * nh // n, (r + 1) * nh // n),
            slice(r * conv_dim // n, (r + 1) * conv_dim // n))


def _cols_whole(t: torch.Tensor, width: int, mesh) -> torch.Tensor:
    """``t`` with all ``width`` columns: this rank's block of them (a
    column-parallel result, the conv output) gathered over ``model``; a
    ``t`` every rank computes whole (``in_bc``'s, replicated over
    ``model``) is passed on with its gradient summed over ``model``, as
    the gather's backward sums it: each rank's heads use all of it."""
    if mesh is None:
        return t
    if t.shape[-1] == width:
        return shd.grad_all_reduce(t, mesh, shd.tp_axis(mesh))
    return shd.all_gather(t, mesh, shd.tp_axis(mesh), t.dim() - 1)


def _project_in(p, x, cfg, kw, mesh=None, heads=None):
    """(z, xs, bb, cc, dt) through the fused or the split projections; in
    the sharded serving layout (``mesh``) z and dt are the ``heads``'
    blocks, xs, bb and cc whole.  Under autograd the column-parallel
    products take ``x`` through ``layers.tp_input``; ``in_bc``, whole on
    every rank, takes it as it is (its gradient is summed over ``model``
    after it, by :func:`_cols_whole`)."""
    di, nh, hp, ns, _ = _dims(cfg)
    kw = dict(kw, tp_pattern="col")
    xt = tp_input(x, kw)
    if cfg.ssm_split_proj:
        bc = _cols_whole(linear(p["in_bc"], x, **kw), 2 * ns, mesh)
        return (linear(p["in_z"], xt, **kw), _cols_whole(linear(p["in_x"], xt, **kw), di, mesh),
                bc[..., :ns], bc[..., ns:], linear(p["in_dt"], xt, **kw))
    z, xs, bb, cc, dt = _split_proj(
        _cols_whole(linear(p["in_proj"], xt, **kw), 2 * di + 2 * ns + nh, mesh), cfg)
    if mesh is not None:
        z, dt = z[..., heads.start * hp:heads.stop * hp], dt[..., heads]
    return z, xs, bb, cc, dt


def _gate_out(p, y, xh, z, x_dtype, cfg, kw, mesh=None):
    """D skip, the ``silu(z)`` gate, the gated RMSNorm and ``out_proj``
    (in the sharded serving layout on this rank's heads, the norm's sum of
    squares all-reduced over ``model``)."""
    b, s = y.shape[:2]
    y = y + xh.to(_F32) * p["d_skip"].to(_F32)[None, None, :, None]
    y = y.reshape(b, s, -1).to(x_dtype)
    y = y * F.silu(z)
    if mesh is None or y.shape[-1] == cfg.d_inner:
        y = rms_norm(y, p["norm_scale"])
    else:
        y = _rms_norm_split(y, p["norm_scale"], mesh, cfg.d_inner)
    return linear(p["out_proj"], y, **dict(kw, tp_pattern="row"))


def _rms_norm_split(y, scale, mesh, width: int, eps: float = 1e-6):
    """:func:`rms_norm` of a row whose ``width`` columns are split over
    ``model``: this rank's block, normalized by the all-reduced sum of
    squares (whose gradient is summed over ``model`` too)."""
    yf = y.to(_F32)
    sq = shd.shared_all_reduce(yf.square().sum(dim=-1, keepdim=True), mesh,
                               shd.tp_axis(mesh))
    return (yf * torch.rsqrt(sq / width + eps) * scale.to(_F32)).to(y.dtype)


def _dt_a(p, dt):
    dt = F.softplus(dt.to(_F32) + p["dt_bias"].to(_F32))
    return dt, -torch.exp(p["a_log"].to(_F32))


def ssm_apply(p: dict, x: torch.Tensor, cfg, chunk: int = 256,
              return_state: bool = False, **kw):
    """Full-sequence SSD mixer.  x: (B, S, D).  With ``return_state`` also
    ``(conv tail (B, W-1, conv_dim), state (B, nh, hp, ns) f32)``; a prompt
    shorter than ``W-1`` gets a tail left-padded with zeros (the inputs
    before the sequence's start).  In the sharded serving layout (the module
    docstring) the tail is this rank's channel block and the state its
    heads."""
    b, s, _ = x.shape
    di, nh, hp, ns, conv_dim = _dims(cfg)
    mesh, heads, chans = _tp_blocks(cfg, kw)
    z, xs, bb, cc, dt = _project_in(p, x, cfg, kw, mesh, heads)
    xbc_raw = torch.cat([xs, bb, cc], dim=-1)[..., chans]
    w = cfg.ssm_conv - 1
    conv_tail = F.pad(xbc_raw, (0, 0, max(w - s, 0), 0))[:, -w:, :]
    xbc = _conv_seq(xbc_raw, p["conv_w"].to(_F32), p["conv_b"].to(_F32)).to(x.dtype)
    xbc = _cols_whole(xbc, conv_dim, mesh)
    xs, bb, cc = xbc[..., :di], xbc[..., di:di + ns], xbc[..., di + ns:]
    dt, a = _dt_a(p, dt)
    xh = xs.reshape(b, s, nh, hp)[:, :, heads]
    y, h_t = _ssd_chunked(xh, dt, a, bb, cc, chunk)
    out = _gate_out(p, y, xh, z, x.dtype, cfg, kw, mesh)
    if return_state:
        return out, (conv_tail, h_t)
    return out


def ssm_prefill_chunk(p: dict, x: torch.Tensor, cfg, cache: tuple,
                      valid_len: torch.Tensor, chunk: int = 256, **kw):
    """One prefill chunk as a continuation of ``cache = (conv (1, W-1,
    conv_dim), state (1, nh, hp, ns))``; returns ``(out, (conv, state))``.

    ``valid_len`` (a device scalar) counts the chunk's real tokens: padded
    rows get ``dt = 0``, exact no-ops in the recurrence, and the conv tail
    is the ``W-1`` rows of the padded window from ``valid_len`` on (the
    inputs ending at the valid boundary), so the carried state after the
    chunk is the state after ``valid_len`` tokens.
    """
    b, s, _ = x.shape
    di, nh, hp, ns, conv_dim = _dims(cfg)
    conv_state, h0 = cache
    z, xs, bb, cc, dt = _project_in(p, x, cfg, kw)
    xbc_raw = torch.cat([xs, bb, cc], dim=-1)                       # (1, C, cd)
    width = cfg.ssm_conv
    padded = torch.cat([conv_state.to(xbc_raw.dtype), xbc_raw], dim=1)
    w = p["conv_w"].to(_F32)
    out = sum(padded[:, i:i + s, :].to(_F32) * w[i][None, None, :]
              for i in range(width))
    xbc = F.silu(out + p["conv_b"].to(_F32)).to(x.dtype)
    vl = valid_len.to(torch.long).reshape(())
    new_conv = padded.index_select(
        1, vl + torch.arange(width - 1, device=x.device))
    xs, bb, cc = xbc[..., :di], xbc[..., di:di + ns], xbc[..., di + ns:]
    dt, a = _dt_a(p, dt)
    dt = torch.where(torch.arange(s, device=x.device)[None, :, None] < vl, dt,
                     torch.zeros((), dtype=_F32, device=x.device))
    xh = xs.reshape(b, s, nh, hp)
    y, h_t = _ssd_chunked(xh, dt, a, bb, cc, chunk, h0=h0.to(_F32))
    out = _gate_out(p, y, xh, z, x.dtype, cfg, kw)
    return out, (new_conv.to(conv_state.dtype), h_t)


def ssm_decode(p: dict, x: torch.Tensor, cfg, cache: tuple, **kw):
    """O(1) single-token step.  x: (B, 1, D); ``cache = (conv (B, W-1,
    conv_dim), state (B, nh, hp, ns))``; returns ``(out, (conv, state))``,
    new tensors (the caller decides where they go).  In the sharded serving
    layout (the module docstring) the caches are this rank's channel block
    and heads."""
    b = x.shape[0]
    di, nh, hp, ns, conv_dim = _dims(cfg)
    conv_state, h = cache
    mesh, heads, chans = _tp_blocks(cfg, kw)
    z, xs, bb, cc, dt = _project_in(p, x, cfg, kw, mesh, heads)
    xbc = torch.cat([xs, bb, cc], dim=-1)[:, 0, chans]              # (B, cd)
    window = torch.cat([conv_state, xbc[:, None, :]], dim=1)        # (B, W, cd)
    conv_out = torch.einsum("bwc,wc->bc", window.to(_F32), p["conv_w"].to(_F32))
    conv_out = F.silu(conv_out + p["conv_b"].to(_F32))
    new_conv = window[:, 1:, :].to(conv_state.dtype)
    conv_out = _cols_whole(conv_out, conv_dim, mesh)
    xs, bbt, cct = conv_out[:, :di], conv_out[:, di:di + ns], conv_out[:, di + ns:]
    dt, a = _dt_a(p, dt[:, 0])                                      # (B, nh)
    decay = torch.exp(dt * a[None, :])
    xh = xs.reshape(b, nh, hp)[:, heads]
    h_new = (h.to(_F32) * decay[:, :, None, None]
             + (xh * dt[:, :, None])[..., None] * bbt[:, None, None, :])
    y = torch.einsum("bk,bhpk->bhp", cct, h_new)
    return (_gate_out(p, y[:, None], xh[:, None], z, x.dtype, cfg, kw, mesh),
            (new_conv, h_new))


def ssm_cache_spec(cfg, batch: int):
    """(shape, axes) pairs for (conv, state)."""
    di, nh, hp, ns, conv_dim = _dims(cfg)
    conv = ((batch, cfg.ssm_conv - 1, conv_dim), ("batch", None, "ssm_inner"))
    state = ((batch, nh, hp, ns), ("batch", "ssm_heads", None, None))
    return conv, state
