"""Flash attention: a hand-written Hopper kernel and its plain version.

Counterpart of ``mxtpu/ops/attention.py``: ``flash_attention`` in the
(B, H, T, D) layout and the ``_contrib_FlashAttention`` op with the same
attrs. The Pallas kernel ``_fwd_kernel`` there becomes the CUDA kernel
``mxtpu_torch/csrc/flash_attn_fwd.cu``, which runs its products on the
tensor cores (float32 as 3xTF32, which keeps float32-grade error;
bfloat16 as bf16 MMA); ``flash_attention_reference`` beside it is the
plain PyTorch version of the same online softmax.

Dispatch is by the tensors' device, with no fallback: a CPU tensor goes
to the plain version, a CUDA tensor goes to the kernel or the call
raises, and a meta tensor (shape inference) yields an empty result of
the output's shape. ``flash_attention.launches`` counts kernel launches.

The tensor-core kernels are built for head dims 32, 64 and 128. The
wrappers take any D, as mxtpu's kernel takes any D: for D <= 128, q, k
and v (and, for the backward, the output and its gradient) are
zero-padded on the last axis to the next of those widths, the kernel
runs, and the output and the gradients are sliced back to D; the scale
comes from the true D. For D > 128 the width-generic pair
``csrc/flash_attn_wide.cu`` (tensor cores as above, D a runtime
argument split into column groups, one warp's each, and past 256 columns
into blocks along the grid) runs on the unpadded tensors; its launches
count in ``flash_attention.wide_launches`` and
``flash_attention_backward.wide_launches``.

``block_q``/``block_k`` were the TPU kernel's tiling. They are accepted
and recorded on the op for graph compatibility, but they do not choose
the CUDA tiling and the result does not depend on them.

The gradient is ``FlashAttentionFunction``, the counterpart of the
``jax.custom_vjp`` around ``_flash3``: its forward keeps q, k, v, the
output and the row log-sum-exp (natural log; +inf for a row with no live
key), and its backward is the CUDA kernel ``csrc/flash_attn_bwd.cu`` on
the card or ``flash_attention_backward_reference`` on the CPU, both the
standard recompute from the log-sum-exp, never a T x S matrix. The
backward kernel also runs its products on the tensor cores (3xTF32 for
float32, bf16 MMA with P and dS rounded to bf16 as operands), in a dK/dV
and a dQ kernel that each write their output tiles once: no atomics, so
a repeated call gives the same bits.
``flash_attention_backward.launches`` counts backward kernel calls. A
call with no gradient to keep (inference) runs the forward alone and
asks the kernel for no log-sum-exp.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError
from ..diagnostics.programs import kernel_cost as _kernel_cost
from .registry import register, set_replicas

__all__ = ["flash_attention", "flash_attention_reference",
           "flash_attention_backward", "flash_attention_backward_reference",
           "FlashAttentionFunction", "NEG_INF"]

NEG_INF = -1e30
KERNEL = "flash_attn_fwd"
BWD_KERNEL = "flash_attn_bwd"
WIDE_KERNEL = "flash_attn_wide_fwd"
WIDE_BWD_KERNEL = "flash_attn_wide_bwd"
_ERROR_STRING = {KERNEL: "flash_attn_error_string",
                 BWD_KERNEL: "flash_attn_bwd_error_string",
                 WIDE_KERNEL: "flash_attn_wide_error_string",
                 WIDE_BWD_KERNEL: "flash_attn_wide_error_string"}
#: the source (``csrc/<stem>.cu``) that holds each launcher
_SOURCE = {KERNEL: KERNEL, BWD_KERNEL: BWD_KERNEL,
           WIDE_KERNEL: "flash_attn_wide", WIDE_BWD_KERNEL: "flash_attn_wide"}
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _scale(d, sm_scale):
    return float(sm_scale) if sm_scale is not None else 1.0 / (d ** 0.5)


def _acc_dtype(q):
    return torch.float64 if q.dtype == torch.float64 else torch.float32


def flash_attention_reference(q, k, v, causal=False, sm_scale=None,
                              return_lse=False):
    """Plain PyTorch online-softmax attention, (B, H, T, D) layout.

    The arithmetic of the kernel and of mxtpu's ``_streaming``: scores in
    f32, causal mask ``col <= row`` aligned top-left, running max and
    normaliser in f32, ``p`` rounded to ``v.dtype`` before ``p.v`` with an
    f32 accumulator, and ``acc / l`` with ``l == 0 -> 1``. The kv chunk
    of the loop (128) changes rounding only. With ``return_lse`` it also
    returns the rows' log-sum-exp ``m + log(l)`` (B, H, T) in f32, +inf
    where ``l == 0``. float64 inputs are computed in float64 throughout
    (for gradcheck)."""
    block = 128
    t = q.shape[2]
    s_len = k.shape[2]
    scale = _scale(q.shape[-1], sm_scale)
    f32 = _acc_dtype(q)
    qf = q.to(f32)
    m = torch.full(q.shape[:3] + (1,), float("-inf"), dtype=f32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=f32, device=q.device)
    rows = torch.arange(t, device=q.device)[:, None]
    stop = min(s_len, t) if causal else s_len
    for k0 in range(0, stop, block):
        kc = k[:, :, k0:k0 + block].to(f32)
        vc = v[:, :, k0:k0 + block]
        s = torch.matmul(qf, kc.transpose(-1, -2)) * scale
        if causal:
            cols = torch.arange(k0, k0 + kc.shape[2], device=q.device)
            s = s.masked_fill(cols[None, :] > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.exp(s - m_use)
        alpha = torch.exp(m - m_use)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + torch.matmul(p.to(v.dtype).to(f32), vc.to(f32))
        m = m_new
    out = (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)
    if not return_lse:
        return out
    lse = torch.where(l == 0, float("inf"), m + torch.log(l))
    return out, lse.squeeze(-1)


def flash_attention_backward_reference(q, k, v, out, dout, lse,
                                       causal=False, sm_scale=None):
    """Plain PyTorch gradient of ``flash_attention`` (dq, dk, dv), by the
    recompute the kernel does: ``P = exp(S - lse)``, ``delta =
    rowsum(dO * O)``, ``dV = P^T dO``, ``dP = dO V^T``, ``dS = P (dP -
    delta)``, ``dQ = scale dS K``, ``dK = scale dS^T Q``, with the
    forward's masks. It streams over kv chunks of 128, so it holds
    O(T x chunk) scores at a time, in f32 (float64 for float64 inputs);
    the gradients come back in the inputs' dtypes. ``lse`` is the
    forward's (B, H, T) log-sum-exp."""
    block = 128
    t = q.shape[2]
    s_len = k.shape[2]
    scale = _scale(q.shape[-1], sm_scale)
    f32 = _acc_dtype(q)
    qf = q.to(f32)
    gf = dout.to(f32)
    delta = (gf * out.to(f32)).sum(dim=-1, keepdim=True)
    lse_ = lse.to(f32).unsqueeze(-1)
    dq = torch.zeros(q.shape, dtype=f32, device=q.device)
    dk = torch.zeros(k.shape, dtype=f32, device=q.device)
    dv = torch.zeros(v.shape, dtype=f32, device=q.device)
    rows = torch.arange(t, device=q.device)[:, None]
    stop = min(s_len, t) if causal else s_len
    for k0 in range(0, stop, block):
        kc = k[:, :, k0:k0 + block].to(f32)
        vc = v[:, :, k0:k0 + block].to(f32)
        p = torch.exp(torch.matmul(qf, kc.transpose(-1, -2)) * scale - lse_)
        if causal:
            cols = torch.arange(k0, k0 + kc.shape[2], device=q.device)
            p = p.masked_fill(cols[None, :] > rows, 0.0)
        dv[:, :, k0:k0 + block] = torch.matmul(p.transpose(-1, -2), gf)
        ds = p * (torch.matmul(gf, vc.transpose(-1, -2)) - delta)
        dq += torch.matmul(ds, kc)
        dk[:, :, k0:k0 + block] = torch.matmul(ds.transpose(-1, -2), qf)
    return ((dq * scale).to(q.dtype), (dk * scale).to(k.dtype),
            dv.to(v.dtype))


def check_kernel_inputs(q, k, v):
    """Raise MXNetError unless q, k, v are what the CUDA kernel takes:
    CUDA tensors on one device, float32 or bfloat16 alike, contiguous,
    q (B, H, T, D) and k, v (B, H, S, D) with D in (32, 64, 128) (the
    padded kernels) or above 128 (the wide pair)."""
    for name, x in (("q", q), ("k", k), ("v", v)):
        if x.dtype not in _DTYPE_CODES:
            raise MXNetError("flash_attention kernel: %s has dtype %s; it "
                             "takes float32 or bfloat16" % (name, x.dtype))
        if not x.is_contiguous():
            raise MXNetError("flash_attention kernel: %s is not contiguous"
                             % name)
        if x.ndim != 4:
            raise MXNetError("flash_attention kernel: %s must be "
                             "(B, H, T, D), got %s" % (name, tuple(x.shape)))
    if k.dtype != q.dtype or v.dtype != q.dtype:
        raise MXNetError("flash_attention kernel: q, k, v dtypes differ "
                         "(%s, %s, %s)" % (q.dtype, k.dtype, v.dtype))
    b, h, _, d = q.shape
    if d not in _HEAD_DIMS and d <= _HEAD_DIMS[-1]:
        raise MXNetError("flash_attention kernel: head dim %d not in %s nor "
                         "above %d" % (d, _HEAD_DIMS, _HEAD_DIMS[-1]))
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise MXNetError("flash_attention kernel: k %s / v %s do not match "
                         "q %s" % (tuple(k.shape), tuple(v.shape),
                                   tuple(q.shape)))
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise MXNetError("flash_attention kernel: %s is on %s; q, k, v "
                             "must be on one CUDA device" % (name, x.device))


_kernel_lock = threading.Lock()
_kernel_fns = {}


def bind(lib, name):
    """(launcher, error_string) of kernel ``name`` in the ctypes library
    ``lib``, with their C signatures set: the one binding of the
    launchers' interface (``chip_smoke.py --parent`` binds another tree's
    build with it too)."""
    fn = getattr(lib, name)
    n_ptr = 5 if name in (KERNEL, WIDE_KERNEL) else 10
    fn.argtypes = [ctypes.c_void_p] * n_ptr + [ctypes.c_int] * 4 + [
        ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
    fn.restype = ctypes.c_int
    err = getattr(lib, _ERROR_STRING[name])
    err.argtypes = [ctypes.c_int]
    err.restype = ctypes.c_char_p
    return fn, err


def _kernel(name=KERNEL):
    """(launcher, error_string) of launcher ``name``, its library built
    and bound on first use."""
    with _kernel_lock:
        if name not in _kernel_fns:
            from .. import build
            _kernel_fns[name] = bind(build.load(_SOURCE[name]), name)
        return _kernel_fns[name]


def _raise_on(rc, name, err):
    if rc != 0:
        raise MXNetError("%s launch failed: %s (cuda error %d)"
                         % (name, err(rc).decode(), rc))


def _launch(kernel, q, k, v, causal, scale, want_lse=False):
    """out (and lse) of one call of the forward launcher ``kernel`` (a
    ``bind`` pair) on checked inputs, on q's current stream. Counts
    nothing."""
    fn, err = kernel
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    lse = torch.empty((b, h, t), dtype=torch.float32, device=q.device) \
        if want_lse else None
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                lse.data_ptr() if want_lse else None, b * h, t, k.shape[2],
                d, scale, int(bool(causal)), _DTYPE_CODES[q.dtype], stream)
    _raise_on(rc, KERNEL, err)
    return (out, lse) if want_lse else out


def _wide(q):
    """Whether q's head dim takes the wide pair (D > 128)."""
    return q.shape[-1] > _HEAD_DIMS[-1]


def _flash_cuda(q, k, v, causal, scale, want_lse=False):
    """The forward kernel for q's head dim (``flash_attn_fwd`` at D in
    _HEAD_DIMS, the wide one above 128) after the checks; one count of
    ``flash_attention.launches`` or ``.wide_launches``."""
    check_kernel_inputs(q, k, v)
    wide = _wide(q)
    res = _launch(_kernel(WIDE_KERNEL if wide else KERNEL), q, k, v, causal,
                  scale, want_lse=want_lse)
    with _kernel_lock:
        if wide:
            flash_attention.wide_launches += 1
        else:
            flash_attention.launches += 1
    b, h, t, d = q.shape
    n_kv = k.shape[2]
    _kernel_cost(4.0 * d * _pairs(t, n_kv, causal) * b * h,
                          2 * b * h * (t + n_kv) * d * q.element_size())
    return res


def _flash_bwd_cuda(q, k, v, out, dout, lse, causal, scale):
    """(dq, dk, dv) from the backward kernel for q's head dim (delta,
    dK/dV and dQ launches on the current stream: ``flash_attn_bwd`` at D
    in _HEAD_DIMS, the wide kernels above 128), after the checks; one
    count of ``flash_attention_backward.launches`` or ``.wide_launches``."""
    check_kernel_inputs(q, k, v)
    for name, x, like in (("out", out, q), ("dout", dout, q)):
        if x.shape != like.shape or x.dtype != like.dtype or \
                not x.is_contiguous() or x.device != q.device:
            raise MXNetError("flash_attention_backward kernel: %s must be a "
                             "contiguous %s %s on %s" % (
                                 name, like.dtype, tuple(like.shape),
                                 q.device))
    if lse.shape != q.shape[:3] or lse.dtype != torch.float32 or \
            not lse.is_contiguous() or lse.device != q.device:
        raise MXNetError("flash_attention_backward kernel: lse must be a "
                         "contiguous float32 %s on %s"
                         % (tuple(q.shape[:3]), q.device))
    wide = _wide(q)
    res = _launch_bwd(_kernel(WIDE_BWD_KERNEL if wide else BWD_KERNEL), q, k,
                      v, out, dout, lse, causal, scale)
    with _kernel_lock:
        if wide:
            flash_attention_backward.wide_launches += 1
        else:
            flash_attention_backward.launches += 1
    b, h, t, d = q.shape
    n_kv = k.shape[2]
    _kernel_cost(10.0 * d * _pairs(t, n_kv, causal) * b * h,
                          4 * b * h * (t + n_kv) * d * q.element_size()
                          + b * h * t * 4)
    return res


def _pairs(t, s, causal):
    """Live (row, key) pairs of one head (``chip_smoke.attention_pairs``):
    every pair, or min(row + 1, S) keys a row under the causal mask."""
    if not causal:
        return t * s
    n = min(t, s)
    return n * (n + 1) // 2 + max(t - s, 0) * s


def _launch_bwd(kernel, q, k, v, out, dout, lse, causal, scale):
    """(dq, dk, dv) of one call of the backward launcher ``kernel`` (a
    ``bind`` pair) on checked inputs, on q's current stream. Counts
    nothing."""
    fn, err = kernel
    b, h, t, d = q.shape
    dq = torch.empty_like(q)
    dk = torch.empty_like(k)
    dv = torch.empty_like(v)
    delta = torch.empty_like(lse)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                dout.data_ptr(), lse.data_ptr(), delta.data_ptr(),
                dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), b * h, t,
                k.shape[2], d, scale, int(bool(causal)),
                _DTYPE_CODES[q.dtype], stream)
    _raise_on(rc, BWD_KERNEL, err)
    return dq, dk, dv


def _kernel_width(q, k, v):
    """The kernels' head dim for q, k, v of head dim D, by D alone: the
    least of _HEAD_DIMS that is >= D (the padded kernels), D itself above
    128 (the wide pair, unpadded). Unequal head dims raise MXNetError."""
    d = q.shape[-1]
    if k.shape[-1] != d or v.shape[-1] != d:
        raise MXNetError("flash_attention kernel: head dims differ (q %d, k "
                         "%d, v %d)" % (d, k.shape[-1], v.shape[-1]))
    for width in _HEAD_DIMS:
        if d <= width:
            return width
    return d


def _pad_head(x, width):
    """x zero-padded on its last axis to ``width`` (x itself when it is
    that wide). Zero columns add nothing to q.k^T, so the scores and the
    lse are unchanged and the padded columns of the output and of the
    gradients are zero."""
    d = x.shape[-1]
    return x if d == width else torch.nn.functional.pad(x, (0, width - d))


def _unpad_head(x, d):
    """x's first ``d`` columns of its last axis, contiguous."""
    return x if x.shape[-1] == d else x[..., :d].contiguous()


def _flash_forward(q, k, v, causal, scale, want_lse=False):
    """The forward by device: plain on the CPU, an empty result of the
    output's shape on meta tensors, the kernel on CUDA (or a raise), on
    q, k, v padded to the kernel's head dim and the output sliced back."""
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=scale,
                                         return_lse=want_lse)
    if q.device.type == "meta":
        out = torch.empty_like(q)
        if want_lse:
            return out, torch.empty(q.shape[:3], dtype=torch.float32,
                                    device="meta")
        return out
    width = _kernel_width(q, k, v)
    res = _flash_cuda(*(_pad_head(x, width) for x in (q, k, v)), causal,
                      scale, want_lse=want_lse)
    if not want_lse:
        return _unpad_head(res, q.shape[-1])
    return _unpad_head(res[0], q.shape[-1]), res[1]


def flash_attention_backward(q, k, v, out, dout, lse, causal=False,
                             sm_scale=None):
    """(dq, dk, dv) of ``flash_attention`` from its output and row
    log-sum-exp, dispatched by device like the forward: the plain version
    on the CPU, the kernel on CUDA (or a raise), empty results on meta."""
    scale = _scale(q.shape[-1], sm_scale)
    if q.device.type == "cpu":
        return flash_attention_backward_reference(
            q, k, v, out, dout, lse, causal=causal, sm_scale=scale)
    if q.device.type == "meta":
        return torch.empty_like(q), torch.empty_like(k), torch.empty_like(v)
    width = _kernel_width(q, k, v)
    grads = _flash_bwd_cuda(*(_pad_head(x, width) for x in (
        q, k, v, out, dout.contiguous())), lse, causal, scale)
    return tuple(_unpad_head(g, q.shape[-1]) for g in grads)


flash_attention_backward.launches = 0
flash_attention_backward.wide_launches = 0


class FlashAttentionFunction(torch.autograd.Function):
    """Flash attention with its gradient: the forward keeps q, k, v, the
    output and the log-sum-exp; the backward recomputes from them."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale):
        out, lse = _flash_forward(q, k, v, causal, scale, want_lse=True)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal = causal
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_backward(q, k, v, out, dout, lse,
                                              causal=ctx.causal,
                                              sm_scale=ctx.scale)
        return dq, dk, dv, None, None


def flash_attention(q, k, v, causal=False, sm_scale=None, block_q=512,
                    block_k=1024):
    """Multi-head attention, (B, H, T, D) layout. ``block_q``/``block_k``
    are accepted for compatibility with the TPU op and do not change the
    tiling or the result. Under autograd, with an input that needs a
    gradient, the call records ``FlashAttentionFunction``."""
    del block_q, block_k
    scale = _scale(q.shape[-1], sm_scale)
    if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad
                                    or v.requires_grad):
        return FlashAttentionFunction.apply(q, k, v, bool(causal), scale)
    return _flash_forward(q, k, v, causal, scale)


flash_attention.launches = 0
flash_attention.wide_launches = 0


def _flash_op(a, q, k, v):
    # the graph hands over transposed views; the kernel takes contiguous
    return flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                           causal=a.causal,
                           sm_scale=(a.sm_scale if a.sm_scale != 0.0
                                     else None),
                           block_q=a.block_q, block_k=a.block_k)


register("_contrib_FlashAttention", _flash_op,
         arg_names=["query", "key", "value"],
         attrs={"causal": False, "sm_scale": 0.0, "block_q": 512,
                "block_k": 1024},
         aliases=("flash_attention",))
set_replicas(["_contrib_FlashAttention"])
