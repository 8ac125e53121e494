"""Flash attention: a hand-written Hopper kernel and its plain version.

Counterpart of ``mxtpu/ops/attention.py``: ``flash_attention`` in the
(B, H, T, D) layout and the ``_contrib_FlashAttention`` op with the same
attrs. The Pallas kernel ``_fwd_kernel`` there becomes the CUDA kernel
``mxtpu_torch/csrc/flash_attn_fwd.cu``; ``flash_attention_reference``
beside it is the plain PyTorch version of the same online softmax.

Dispatch is by the tensors' device, with no fallback: a CPU tensor goes
to the plain version, a CUDA tensor goes to the kernel or the call
raises, and a meta tensor (shape inference) yields an empty result of
the output's shape. ``flash_attention.launches`` counts kernel launches.

``block_q``/``block_k`` were the TPU kernel's tiling. They are accepted
and recorded on the op for graph compatibility, but they do not choose
the CUDA tiling and the result does not depend on them. Only the forward
is here; the backward arrives with training.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError
from .registry import register

__all__ = ["flash_attention", "flash_attention_reference", "NEG_INF"]

NEG_INF = -1e30
KERNEL = "flash_attn_fwd"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_HEAD_DIMS = (32, 64, 128)


def _scale(d, sm_scale):
    return float(sm_scale) if sm_scale is not None else 1.0 / (d ** 0.5)


def flash_attention_reference(q, k, v, causal=False, sm_scale=None):
    """Plain PyTorch online-softmax attention, (B, H, T, D) layout.

    The arithmetic of the kernel and of mxtpu's ``_streaming``: scores in
    f32, causal mask ``col <= row`` aligned top-left, running max and
    normaliser in f32, ``p`` rounded to ``v.dtype`` before ``p.v`` with an
    f32 accumulator, and ``acc / l`` with ``l == 0 -> 1``. The kv chunk
    of the loop (128) changes rounding only."""
    block = 128
    t = q.shape[2]
    s_len = k.shape[2]
    scale = _scale(q.shape[-1], sm_scale)
    qf = q.to(torch.float32)
    m = torch.full(q.shape[:3] + (1,), float("-inf"), dtype=torch.float32,
                   device=q.device)
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape, dtype=torch.float32, device=q.device)
    rows = torch.arange(t, device=q.device)[:, None]
    stop = min(s_len, t) if causal else s_len
    for k0 in range(0, stop, block):
        kc = k[:, :, k0:k0 + block].to(torch.float32)
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
        acc = acc * alpha + torch.matmul(p.to(v.dtype).to(torch.float32),
                                         vc.to(torch.float32))
        m = m_new
    return (acc / torch.where(l == 0, 1.0, l)).to(q.dtype)


def check_kernel_inputs(q, k, v):
    """Raise MXNetError unless q, k, v are what the CUDA kernel takes:
    CUDA tensors on one device, float32 or bfloat16 alike, contiguous,
    q (B, H, T, D) and k, v (B, H, S, D) with D in (32, 64, 128)."""
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
    if d not in _HEAD_DIMS:
        raise MXNetError("flash_attention kernel: head dim %d not in %s"
                         % (d, _HEAD_DIMS))
    if k.shape[:2] != (b, h) or k.shape[3] != d or v.shape != k.shape:
        raise MXNetError("flash_attention kernel: k %s / v %s do not match "
                         "q %s" % (tuple(k.shape), tuple(v.shape),
                                   tuple(q.shape)))
    if b * h > 65535:
        raise MXNetError("flash_attention kernel: B*H = %d exceeds 65535"
                         % (b * h))
    for name, x in (("q", q), ("k", k), ("v", v)):
        if not x.is_cuda or x.device != q.device:
            raise MXNetError("flash_attention kernel: %s is on %s; q, k, v "
                             "must be on one CUDA device" % (name, x.device))


_kernel_lock = threading.Lock()
_kernel_fn = None


def _kernel():
    global _kernel_fn
    with _kernel_lock:
        if _kernel_fn is None:
            from .. import build
            lib = build.load(KERNEL)
            fn = lib.flash_attn_fwd
            fn.argtypes = [ctypes.c_void_p] * 4 + [ctypes.c_int] * 4 + [
                ctypes.c_float, ctypes.c_int, ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.flash_attn_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _kernel_fn = (fn, err)
        return _kernel_fn


def _flash_cuda(q, k, v, causal, scale):
    check_kernel_inputs(q, k, v)
    fn, err = _kernel()
    b, h, t, d = q.shape
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
                b * h, t, k.shape[2], d, scale, int(bool(causal)),
                _DTYPE_CODES[q.dtype], stream)
    if rc != 0:
        raise MXNetError("flash_attn_fwd launch failed: %s (cuda error %d)"
                         % (err(rc).decode(), rc))
    with _kernel_lock:
        flash_attention.launches += 1
    return out


def flash_attention(q, k, v, causal=False, sm_scale=None, block_q=512,
                    block_k=1024):
    """Multi-head attention, (B, H, T, D) layout. ``block_q``/``block_k``
    are accepted for compatibility with the TPU op and do not change the
    tiling or the result."""
    del block_q, block_k
    scale = _scale(q.shape[-1], sm_scale)
    if q.device.type == "cpu":
        return flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=scale)
    if q.device.type == "meta":
        return torch.empty_like(q)
    return _flash_cuda(q, k, v, causal, scale)


flash_attention.launches = 0


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
