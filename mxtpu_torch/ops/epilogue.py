"""BN-apply + ReLU (+ residual) epilogue: a hand-written Hopper kernel and
its plain version.

Counterpart of ``mxtpu/ops/epilogue.py``: ``bn_apply_relu_add`` computes
``y = relu(x * scale + shift) [+ residual]`` in f32 and stores it in
``out_dtype`` (default ``x.dtype``); the residual, of the output's type,
is added after the ReLU. x and y are each f32 or bf16: a bf16 x with an
f32 y (or the reverse) is the compile pipeline's bf16 rewrite at a
BatchNorm on the boundary of the bf16 region, where mxtpu's graph
upcasts before the BatchNorm (exactly) or rounds after the ReLU (once). The Pallas kernel
``_kernel`` there becomes the CUDA kernel
``mxtpu_torch/csrc/bn_relu_epilogue.cu``;
``bn_apply_relu_add_reference`` beside it is the plain PyTorch version,
and ``fold_bn`` folds BN statistics into the per-channel scale and shift.

The TPU kernel takes a channel-minor ``(M, C)`` activation. Here ``axis``
names the channel dim of any contiguous ``x``: the kernel sees it as
``(outer, C, inner)``, so ``(M, C)`` (``axis=-1``, the default) and an
NCHW activation (``axis=1``) both run without a transpose copy.

Dispatch is by the tensor's device, with no fallback: a CPU tensor goes
to the plain version, a CUDA tensor goes to the kernel or the call
raises, and a meta tensor yields an empty result of the output's shape.
``bn_apply_relu_add.launches`` counts kernel launches. ``block_m`` was
the TPU kernel's row tiling; it is accepted and does not choose the CUDA
tiling or change the result.
"""
from __future__ import annotations

import ctypes
import threading

import torch

from ..base import MXNetError
from ..diagnostics.programs import kernel_cost as _kernel_cost

__all__ = ["bn_apply_relu_add", "bn_apply_relu_add_reference", "fold_bn",
           "check_kernel_inputs"]

KERNEL = "bn_relu_epilogue"
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
#: the kernel's code of each (x dtype, y dtype) pair
_PAIR_CODES = {(torch.float32, torch.float32): 0,
               (torch.bfloat16, torch.bfloat16): 1,
               (torch.bfloat16, torch.float32): 2,
               (torch.float32, torch.bfloat16): 3}


def fold_bn(gamma, beta, mean, var, eps=1e-5):
    """Fold BN statistics into the per-channel (scale, shift) the apply
    stage consumes: scale = gamma*rsqrt(var+eps), shift = beta-mean*scale."""
    scale = gamma * torch.rsqrt(var + eps)
    return scale, beta - mean * scale


def _bshape(x, axis):
    ax = axis % x.ndim
    return tuple(x.shape[ax] if i == ax else 1 for i in range(x.ndim))


def bn_apply_relu_add_reference(x, scale, shift, residual=None, axis=-1,
                                out_dtype=None):
    """Plain PyTorch version: ``relu(x.float() * scale + shift)``, then
    ``+ residual.float()``, then ``.to(out_dtype or x.dtype)``. The
    multiply and the add are separate ops, so each rounds once, as in the
    kernel."""
    shape = _bshape(x, axis)
    y = x.to(torch.float32) * scale.to(torch.float32).reshape(shape) \
        + shift.to(torch.float32).reshape(shape)
    y = torch.relu(y)
    if residual is not None:
        y = y + residual.to(torch.float32)
    return y.to(out_dtype or x.dtype)


def _layout(shape, axis):
    """(outer, C, inner) of a contiguous ``shape`` with channels at
    ``axis``."""
    ax = axis % len(shape)
    outer = inner = 1
    for d in shape[:ax]:
        outer *= d
    for d in shape[ax + 1:]:
        inner *= d
    return outer, shape[ax], inner


def check_kernel_inputs(x, scale, shift, residual=None, axis=-1,
                        out_dtype=None):
    """Raise MXNetError unless the inputs are what the CUDA kernel takes:
    x float32 or bfloat16, contiguous, with a channel dim at ``axis``;
    ``out_dtype`` (default x's) float32 or bfloat16; scale and shift
    float32, contiguous, of shape (C,); residual (if given) of x's shape
    and the output's dtype, contiguous; all on one CUDA device."""
    out_dtype = out_dtype or x.dtype
    if x.dtype not in _DTYPE_CODES:
        raise MXNetError("bn_apply_relu_add kernel: x has dtype %s; it takes "
                         "float32 or bfloat16" % x.dtype)
    if out_dtype not in _DTYPE_CODES:
        raise MXNetError("bn_apply_relu_add kernel: out_dtype %s; it writes "
                         "float32 or bfloat16" % out_dtype)
    if x.ndim < 1 or not -x.ndim <= axis < x.ndim:
        raise MXNetError("bn_apply_relu_add kernel: axis %d is out of range "
                         "for x of shape %s" % (axis, tuple(x.shape)))
    c = x.shape[axis]
    named = [("x", x), ("scale", scale), ("shift", shift)]
    for name, v in (("scale", scale), ("shift", shift)):
        if v.dtype != torch.float32:
            raise MXNetError("bn_apply_relu_add kernel: %s has dtype %s; it "
                             "takes float32" % (name, v.dtype))
        if tuple(v.shape) != (c,):
            raise MXNetError("bn_apply_relu_add kernel: %s has shape %s, not "
                             "(%d,)" % (name, tuple(v.shape), c))
    if residual is not None:
        named.append(("residual", residual))
        if residual.dtype != out_dtype or residual.shape != x.shape:
            raise MXNetError("bn_apply_relu_add kernel: residual %s %s does "
                             "not match the output %s %s"
                             % (residual.dtype, tuple(residual.shape),
                                out_dtype, tuple(x.shape)))
    for name, v in named:
        if not v.is_contiguous():
            raise MXNetError("bn_apply_relu_add kernel: %s is not contiguous"
                             % name)
        if not v.is_cuda or v.device != x.device:
            raise MXNetError("bn_apply_relu_add kernel: %s is on %s; every "
                             "input must be on one CUDA device"
                             % (name, v.device))


_kernel_lock = threading.Lock()
_kernel_fn = None


def _kernel():
    global _kernel_fn
    with _kernel_lock:
        if _kernel_fn is None:
            from .. import build
            lib = build.load(KERNEL)
            fn = lib.bn_relu_epilogue
            fn.argtypes = [ctypes.c_void_p] * 5 + [ctypes.c_longlong] * 3 + [
                ctypes.c_int, ctypes.c_void_p]
            fn.restype = ctypes.c_int
            err = lib.bn_relu_epilogue_error_string
            err.argtypes = [ctypes.c_int]
            err.restype = ctypes.c_char_p
            _kernel_fn = (fn, err)
        return _kernel_fn


def _epilogue_cuda(x, scale, shift, residual, axis, out_dtype):
    check_kernel_inputs(x, scale, shift, residual, axis, out_dtype)
    out = torch.empty_like(x, dtype=out_dtype)
    if x.numel() == 0:
        return out
    fn, err = _kernel()
    outer, c, inner = _layout(tuple(x.shape), axis)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream(x.device).cuda_stream
        rc = fn(x.data_ptr(), scale.data_ptr(), shift.data_ptr(),
                residual.data_ptr() if residual is not None else None,
                out.data_ptr(), outer, c, inner,
                _PAIR_CODES[(x.dtype, out_dtype)], stream)
    if rc != 0:
        raise MXNetError("bn_relu_epilogue launch failed: %s (cuda error %d)"
                         % (err(rc).decode(), rc))
    with _kernel_lock:
        bn_apply_relu_add.launches += 1
    n = x.numel()
    _kernel_cost(n * (4 if residual is not None else 3),
                          n * (x.element_size() + out.element_size() * (
                              2 if residual is not None else 1))
                          + 2 * c * 4)
    return out


def bn_apply_relu_add(x, scale, shift, residual=None, block_m=1024,
                      axis=-1, out_dtype=None):
    """y = relu(x * scale + shift) [+ residual], one pass over x.

    x float32/bfloat16 with its channels at ``axis`` (``(M, C)`` by
    default); scale/shift (C,) float32; y of ``out_dtype`` (default x's);
    residual optional, of x's shape and y's dtype. ``block_m`` is
    accepted for the TPU op's signature and does not change the tiling or
    the result."""
    del block_m
    out_dtype = out_dtype or x.dtype
    if x.device.type == "cpu":
        return bn_apply_relu_add_reference(x, scale, shift, residual, axis,
                                           out_dtype)
    if x.device.type == "meta":
        return torch.empty_like(x, dtype=out_dtype)
    return _epilogue_cuda(x, scale, shift, residual, axis, out_dtype)


bn_apply_relu_add.launches = 0
