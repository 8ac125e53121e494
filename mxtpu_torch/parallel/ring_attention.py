"""Sequence-parallel attention over a mesh axis, on the flash kernels.

Counterpart of ``mxtpu/parallel/ring_attention.py``: ``blockwise_attention``
(:48), ``ring_attention`` (:90) and ``ulysses_attention`` (:133). Each
takes the global ``(B, T, H, D)`` q, k, v and returns the global output,
as mxtpu's ``shard_map`` wrappers do; inside, device r of the axis works
on its ``T/p`` slice, in the kernels' ``(B, H, T, D)`` layout
(contiguous). mxtpu computes each block in jnp (``_block_attn`` :29);
the port computes the same function with the hand-written kernels.

- ``ring_attention``: K/V blocks travel the ring (``ppermute``, i -> i+1)
  while each device's queries stay. Each hop is one launch of the flash
  forward kernel with its log-sum-exp (``want_lse``): the diagonal hop
  causal (top-left alignment is exact for a square block), earlier blocks
  whole; a block from a later rank contributes nothing under the causal
  mask, so its hop is skipped while its K/V still travel on. The hops
  merge through their log-sum-exps in f32. The backward
  (``_RingAttention``) calls the flash backward kernel once per hop with
  the global output and log-sum-exp of the device's rows: dQ accumulates
  on the query's device, dK and dV travel the ring with their K/V block
  and arrive back at its owner after the last hop.
- ``ulysses_attention``: an all-to-all turns sequence slices into head
  slices, each device runs ``FlashAttentionFunction`` over the whole
  sequence on H/p heads, and a second all-to-all turns them back; autograd
  runs the same in reverse.
- ``blockwise_attention``: one device's attention through
  ``flash_attention``.

``block_size`` (like the kernel's ``block_q``/``block_k``) is accepted and
does not choose the tiling. On the CPU every hop is the plain
``flash_attention_reference`` / ``flash_attention_backward_reference``;
on CUDA the kernels run or the call raises.
"""
from __future__ import annotations

import torch

from ..base import MXNetError
from ..ops import attention as _att
from ..ops.collective import AllToAll, ppermute
from .mesh import axis_devices, current_mesh

__all__ = ["blockwise_attention", "ring_attention", "ulysses_attention"]


def _devices(mesh, axis_name):
    if mesh is None:
        mesh = current_mesh()
    return [c.torch_device for c in axis_devices(mesh, axis_name)]


def _check(q, k, v, p):
    if q.dim() != 4 or k.shape != q.shape or v.shape != q.shape:
        raise MXNetError("sequence-parallel attention takes q, k, v of one "
                         "(B, T, H, D) shape, got %s %s %s"
                         % (tuple(q.shape), tuple(k.shape), tuple(v.shape)))
    if q.shape[1] % p:
        raise MXNetError("sequence length %d does not split over %d devices"
                         % (q.shape[1], p))


def blockwise_attention(q, k, v, block_size=512, causal=False,
                        axis_name=None):
    """Attention on one device, q (B, Tq, H, D), k/v (B, Tk, H, D), by the
    flash kernel (``flash_attention``, with its gradient under autograd);
    ``block_size`` does not choose the tiling."""
    del block_size, axis_name
    out = _att.flash_attention(q.transpose(1, 2).contiguous(),
                               k.transpose(1, 2).contiguous(),
                               v.transpose(1, 2).contiguous(),
                               causal=causal)
    return out.transpose(1, 2)


def _local(x, r, p, dev):
    """Rows r of p of global (B, T, H, D) ``x`` on ``dev``, as
    (B, H, T/p, D) contiguous."""
    t = x.shape[1] // p
    return x[:, r * t:(r + 1) * t].to(dev).transpose(1, 2).contiguous()


def _merge(parts, dtype):
    """(out, lse) of the hops of one set of rows merged through their
    log-sum-exps in f32. Every row has a live key in every hop that runs
    (whole blocks, or the diagonal block's own key), so every lse is
    finite."""
    if len(parts) == 1:
        return parts[0]
    lses = torch.stack([l for _, l in parts])
    lse = torch.logsumexp(lses, dim=0)
    out = sum(torch.exp(l - lse).unsqueeze(-1) * o.float()
              for (o, _), l in zip(parts, lses))
    return out.to(dtype), lse


def _ring_perm(p):
    return [(i, (i + 1) % p) for i in range(p)]


class _RingAttention(torch.autograd.Function):
    """The ring over ``devs`` (forward and backward as in the module
    docstring); inputs and output global (B, T, H, D) on q's device."""

    @staticmethod
    def forward(ctx, q, k, v, devs, causal, scale):
        p = len(devs)
        qs = [_local(q, r, p, d) for r, d in enumerate(devs)]
        ks = [_local(k, r, p, d) for r, d in enumerate(devs)]
        vs = [_local(v, r, p, d) for r, d in enumerate(devs)]
        parts = [[] for _ in devs]
        kc, vc = ks, vs
        for hop in range(p):
            for r in range(p):
                src = (r - hop) % p
                if causal and src > r:
                    continue
                parts[r].append(_att._flash_forward(
                    qs[r], kc[r], vc[r], causal and src == r, scale,
                    want_lse=True))
            if hop < p - 1:
                kc, vc = ppermute(kc, _ring_perm(p)), \
                    ppermute(vc, _ring_perm(p))
        merged = [_merge(pr, q.dtype) for pr in parts]
        outs = [o for o, _ in merged]
        ctx.devs, ctx.causal, ctx.scale = devs, causal, scale
        ctx.locals = (qs, ks, vs, outs, [l for _, l in merged])
        home = q.device
        return torch.cat([o.to(home).transpose(1, 2) for o in outs], dim=1)

    @staticmethod
    def backward(ctx, dout):
        devs, causal, scale = ctx.devs, ctx.causal, ctx.scale
        qs, ks, vs, outs, lses = ctx.locals
        p = len(devs)
        home = dout.device
        dos = [_local(dout, r, p, d) for r, d in enumerate(devs)]
        dq = [torch.zeros(x.shape, dtype=torch.float32, device=x.device)
              for x in qs]
        dk = [torch.zeros_like(x) for x in dq]
        dv = [torch.zeros_like(x) for x in dq]
        kc, vc = ks, vs
        perm = _ring_perm(p)
        for hop in range(p):
            for r in range(p):
                src = (r - hop) % p
                if causal and src > r:
                    continue
                g = _att.flash_attention_backward(
                    qs[r], kc[r], vc[r], outs[r], dos[r], lses[r],
                    causal=causal and src == r, sm_scale=scale)
                dq[r] += g[0].float()
                dk[r] += g[1].float()
                dv[r] += g[2].float()
            # dK/dV ride with their block; after p moves each is home
            dk, dv = ppermute(dk, perm), ppermute(dv, perm)
            if hop < p - 1:
                kc, vc = ppermute(kc, perm), ppermute(vc, perm)
        ctx.locals = None

        def glob(parts, like):
            return torch.cat([x.to(home).transpose(1, 2) for x in parts],
                             dim=1).to(like.dtype)
        return (glob(dq, qs[0]), glob(dk, ks[0]), glob(dv, vs[0]), None,
                None, None)


def ring_attention(q, k, v, mesh=None, axis_name="seq", causal=False):
    """Attention over the whole sequence with q, k, v split on T over the
    mesh axis ``axis_name`` (the other axes replicate): K/V blocks rotate
    p-1 times around the ring; each hop is one flash forward launch."""
    devs = _devices(mesh, axis_name)
    _check(q, k, v, len(devs))
    return _RingAttention.apply(q, k, v, devs, bool(causal),
                                _att._scale(q.shape[-1], None))


def ulysses_attention(q, k, v, mesh=None, axis_name="seq", causal=False):
    """All-to-all sequence parallelism: sequence slices become head
    slices (H divisible by the axis size), each device attends over the
    whole sequence with ``FlashAttentionFunction``, and a second
    all-to-all restores the sequence slices."""
    devs = _devices(mesh, axis_name)
    p = len(devs)
    _check(q, k, v, p)
    b, t, h, d = q.shape
    if h % p:
        raise MXNetError("ulysses needs heads (%d) divisible by axis size "
                         "(%d)" % (h, p))
    tl, hp = t // p, h // p

    def to_heads(x):
        # (B, T/p, p, H/p, D) per device -> head group r over all of T
        parts = [x.narrow(1, r * tl, tl).to(dev).reshape(b, tl, p, hp, d)
                 for r, dev in enumerate(devs)]
        return [y.reshape(b, t, hp, d).transpose(1, 2).contiguous()
                for y in AllToAll.apply(2, 1, *parts)]

    outs = [_att.flash_attention(qh, kh, vh, causal=causal)
            for qh, kh, vh in zip(to_heads(q), to_heads(k), to_heads(v))]
    back = AllToAll.apply(1, 2, *[o.transpose(1, 2).reshape(b, t, 1, hp, d)
                                  for o in outs])
    home = q.device
    return torch.cat([y.reshape(b, tl, h, d).to(home) for y in back], dim=1)
