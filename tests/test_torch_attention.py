"""mxtpu_torch flash attention vs mxtpu's: the port's plain version
(what a CPU tensor runs) against ``mxtpu.ops.attention.flash_attention``,
which at B*H*T*S <= 2**22 runs its Pallas kernel in interpret mode on the
CPU, as the JAX package's own tests run it (D = 96 too). float32 within
atol 1e-4, bfloat16 within 2e-2 (p is rounded to bf16 at different
points of the two online softmaxes). Also the wrapper's dispatch: a CPU
tensor takes the plain version and launches nothing, the head-dim pad of
the card's wrappers (D <= 128 to the next built width) leaves the plain
forward and backward unchanged in float64, D in (128, 512] goes unpadded
to the wide pair (D = 160 and 256 held against mxtpu too) and D > 512
raises, the kernel's input checks
raise, and the module has no try/fallback. Then chip_smoke's flash bounds (f32 on
the tensor cores as 3xTF32) and its reading of ptxas, and CPU emulations
of the forward's and the backward's f32 arithmetic that show why both
run 3xTF32."""
import ast
import inspect
import os

import numpy as np
import pytest

from mxtpu.ops import attention as jatt


@pytest.fixture(scope="module")
def tt():
    import torch
    torch.set_num_threads(1)
    import mxtpu_torch
    from mxtpu_torch.ops import attention as att
    return torch, mxtpu_torch, att


def _qkv(b, h, t, s, d, seed=0):
    rng = np.random.RandomState(seed)
    return (rng.randn(b, h, t, d).astype(np.float32) * 0.5,
            rng.randn(b, h, s, d).astype(np.float32) * 0.5,
            rng.randn(b, h, s, d).astype(np.float32) * 0.5)


def _jax_flash(q, k, v, dtype, **kw):
    import jax.numpy as jnp
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    out = jatt.flash_attention(jnp.asarray(q, jdt), jnp.asarray(k, jdt),
                               jnp.asarray(v, jdt), **kw)
    return np.asarray(out.astype(jnp.float32))


def _port_flash(tt, q, k, v, dtype, **kw):
    torch, _, att = tt
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    out = att.flash_attention(*(torch.from_numpy(x).to(tdt)
                                for x in (q, k, v)), **kw)
    assert out.dtype == tdt
    return out.to(torch.float32).numpy()


TOL = {"float32": 1e-4, "bfloat16": 2e-2}


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,t,s,d,block_q,block_k", [
    (1, 2, 128, 128, 64, 512, 1024),   # one block each way
    (2, 2, 128, 128, 32, 64, 64),      # multi-block online softmax
    (1, 2, 64, 160, 32, 64, 64),       # T != S, ragged kv tail
    (1, 1, 96, 96, 64, 32, 64),        # ragged tail, T == S
    (1, 2, 160, 64, 32, 32, 64),       # T > S
    (1, 1, 128, 128, 128, 512, 1024),  # D = 128
])
def test_plain_version_matches_mxtpu_flash(tt, dtype, causal, b, h, t, s,
                                           d, block_q, block_k):
    assert b * h * t * s <= 1 << 22  # the JAX side runs its Pallas kernel
    q, k, v = _qkv(b, h, t, s, d, seed=t + s + d)
    kw = dict(causal=causal, block_q=block_q, block_k=block_k)
    want = _jax_flash(q, k, v, dtype, **kw)
    got = _port_flash(tt, q, k, v, dtype, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,s,d", [(64, 96, 160), (96, 64, 256),
                                   (48, 80, 640)])
def test_plain_version_matches_mxtpu_flash_at_wide_head_dims(tt, dtype,
                                                            causal, t, s, d):
    """D > 128, which the card runs on the wide pair unpadded (D = 640 in
    three 256-column blocks): the plain version against mxtpu's Pallas
    kernel (interpret mode), whose BlockSpecs carry D whole; T != S, a kv
    tail that is not a tile multiple; the tolerances of the D <= 128
    cases."""
    q, k, v = _qkv(1, 2, t, s, d, seed=t + s + d)
    kw = dict(causal=causal, block_q=32, block_k=64)
    want = _jax_flash(q, k, v, dtype, **kw)
    got = _port_flash(tt, q, k, v, dtype, **kw)
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL[dtype])


@pytest.mark.parametrize("causal", [False, True])
def test_plain_version_matches_mxtpu_reference_oracle(tt, causal):
    """Against mxtpu's materialized-softmax oracle ``_reference`` at a
    size past the interpret-mode limit, with a custom sm_scale."""
    torch, _, att = tt
    b, h, t, d = 2, 4, 384, 64
    q, k, v = _qkv(b, h, t, t, d, seed=5)
    import jax.numpy as jnp
    want = np.asarray(jatt._reference(
        jnp.asarray(q.reshape(b * h, t, d)), jnp.asarray(k.reshape(b * h, t, d)),
        jnp.asarray(v.reshape(b * h, t, d)), 0.2, causal)).reshape(q.shape)
    got = att.flash_attention_reference(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal, sm_scale=0.2).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-4)


def test_op_matches_mxtpu_op(tt):
    """The _contrib_FlashAttention op (attrs as the graph stores them)."""
    torch, mt, _ = tt
    import jax.numpy as jnp
    from mxtpu.ops import registry as jreg
    q, k, v = _qkv(1, 2, 64, 64, 32, seed=9)
    attrs = {"causal": "True", "sm_scale": "0.0", "block_q": "32",
             "block_k": "32"}
    _, _, (want,) = jreg.invoke("_contrib_FlashAttention",
                                [jnp.asarray(x) for x in (q, k, v)], attrs)
    _, parsed, (got,) = mt.ops.registry.invoke(
        "_contrib_FlashAttention", [torch.from_numpy(x) for x in (q, k, v)],
        attrs)
    assert (parsed.block_q, parsed.block_k) == (32, 32)  # recorded
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=1e-4)


def test_op_matches_mxtpu_op_at_head_dim_96(tt):
    """D = 96 (d_model 768 over 8 heads), which the card's wrapper pads to
    the kernel's 128: the op against mxtpu's, whose Pallas kernel takes
    the full D (interpret mode here)."""
    torch, mt, _ = tt
    import jax.numpy as jnp
    from mxtpu.ops import registry as jreg
    q, k, v = _qkv(1, 2, 64, 64, 96, seed=11)
    attrs = {"causal": "True", "sm_scale": "0.0"}
    _, _, (want,) = jreg.invoke("_contrib_FlashAttention",
                                [jnp.asarray(x) for x in (q, k, v)], attrs)
    _, _, (got,) = mt.ops.registry.invoke(
        "_contrib_FlashAttention", [torch.from_numpy(x) for x in (q, k, v)],
        attrs)
    assert got.shape == (1, 2, 64, 96)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0,
                               atol=TOL["float32"])


@pytest.mark.parametrize("d,width", [(1, 32), (16, 32), (32, 32), (48, 64),
                                     (80, 128), (96, 128), (112, 128),
                                     (128, 128)])
def test_kernel_width_is_the_next_built_head_dim(tt, d, width):
    torch, _, att = tt
    q = torch.zeros(1, 1, 2, d)
    assert att._kernel_width(q, q, q) == width


@pytest.mark.parametrize("d", [129, 160, 192, 256, 384, 512, 513, 640,
                               1024])
def test_kernel_width_sends_past_128_to_the_wide_pair_unpadded(tt, d):
    """Every D > 128 runs: the width is D itself (no pad), the kernel
    checks take it, and the wrappers pick the wide launchers."""
    torch, _, att = tt
    q = torch.zeros(1, 1, 2, d)
    assert att._kernel_width(q, q, q) == d
    assert att._pad_head(q, d) is q and att._unpad_head(q, d) is q
    assert att._wide(q) and not att._wide(q[..., :128])
    assert att._SOURCE[att.WIDE_KERNEL] == att._SOURCE[att.WIDE_BWD_KERNEL] \
        == "flash_attn_wide"
    with pytest.raises(att.MXNetError, match="CUDA"):  # the last check
        att.check_kernel_inputs(q, q, q)


def test_kernel_width_refuses_past_128_and_unequal_head_dims(tt):
    """Past 512, where the wide pair once stopped, the width is D itself
    (the pair takes any D); unequal head dims raise."""
    torch, mt, att = tt
    q = torch.zeros(1, 1, 2, 513)
    assert att._kernel_width(q, q, q) == 513 and att._wide(q)
    with pytest.raises(mt.MXNetError, match="CUDA"):  # the last check
        att.check_kernel_inputs(q, q, q)
    with pytest.raises(mt.MXNetError, match="head dims differ"):
        att._kernel_width(q[..., :48], q[..., :64], q[..., :48])


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [16, 48, 80, 96])
def test_head_dim_pad_leaves_forward_and_backward_unchanged(tt, d, causal):
    """What the card's wrappers do for D outside (32, 64, 128), on the
    plain versions in float64: q, k, v, out and dO zero-padded to the
    kernel's head dim, the scale from the true D, the output and the
    gradients sliced back. They equal the unpadded plain version within
    1e-12, the lse included, and the padded columns are exactly 0."""
    torch, _, att = tt
    rng = np.random.RandomState(d)
    q, k, v, do = (torch.from_numpy(rng.randn(2, 3, n, d)) for n in
                   (37, 45, 45, 37))
    scale = att._scale(d, None)
    width = att._kernel_width(q, k, v)
    pad = [att._pad_head(x, width) for x in (q, k, v)]
    out, lse = att.flash_attention_reference(q, k, v, causal=causal,
                                             sm_scale=scale, return_lse=True)
    out_p, lse_p = att.flash_attention_reference(*pad, causal=causal,
                                                 sm_scale=scale,
                                                 return_lse=True)
    assert not out_p[..., d:].abs().max()
    assert (att._unpad_head(out_p, d) - out).abs().max() <= 1e-12
    assert (lse_p - lse).abs().max() <= 1e-12
    want = att.flash_attention_backward_reference(q, k, v, out, do, lse,
                                                  causal=causal,
                                                  sm_scale=scale)
    got = att.flash_attention_backward_reference(
        *pad, att._pad_head(out, width), att._pad_head(do, width), lse_p,
        causal=causal, sm_scale=scale)
    for g, w in zip(got, want):
        assert g.shape[-1] == width and not g[..., d:].abs().max()
        g = att._unpad_head(g, d)
        assert g.is_contiguous() and (g - w).abs().max() <= 1e-12


def test_tpu_tiling_attrs_do_not_change_the_result(tt):
    torch, _, att = tt
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 96, 96, 32, seed=2))
    a = att.flash_attention(q, k, v, causal=True, block_q=512, block_k=1024)
    b = att.flash_attention(q, k, v, causal=True, block_q=16, block_k=48)
    assert torch.equal(a, b)


def test_cpu_tensor_takes_the_plain_version_and_launches_nothing(tt):
    torch, _, att = tt
    before = att.flash_attention.launches
    q, k, v = (torch.from_numpy(x) for x in _qkv(1, 2, 32, 32, 32))
    out = att.flash_attention(q, k, v, causal=True)
    ref = att.flash_attention_reference(q, k, v, causal=True)
    assert torch.equal(out, ref)
    assert att.flash_attention.launches == before == 0


def test_meta_tensor_gives_the_output_shape(tt):
    torch, _, att = tt
    q = torch.empty(2, 3, 5, 32, device="meta")
    k = torch.empty(2, 3, 7, 32, device="meta")
    out = att.flash_attention(q, k, k)
    assert out.device.type == "meta" and out.shape == q.shape


@pytest.mark.parametrize("case", ["cpu", "float16", "mixed_dtype",
                                  "non_contiguous", "head_dim_48",
                                  "kv_mismatch", "rank3"])
def test_kernel_input_checks_raise(tt, case):
    """What the CUDA kernel does not take raises before any launch."""
    torch, mt, att = tt
    q = torch.zeros(1, 2, 8, 64)
    k = torch.zeros(1, 2, 8, 64)
    v = torch.zeros(1, 2, 8, 64)
    if case == "float16":
        q, k, v = q.half(), k.half(), v.half()
    elif case == "mixed_dtype":
        k = k.to(torch.bfloat16)
    elif case == "non_contiguous":
        q = torch.zeros(1, 8, 2, 64).transpose(1, 2)
    elif case == "head_dim_48":
        q, k, v = (torch.zeros(1, 2, 8, 48) for _ in range(3))
    elif case == "kv_mismatch":
        v = torch.zeros(1, 2, 9, 64)
    elif case == "rank3":
        q = torch.zeros(2, 8, 64)
    with pytest.raises(mt.MXNetError, match="flash_attention kernel"):
        att.check_kernel_inputs(q, k, v)


def test_attention_module_has_no_fallback(tt):
    """No try/except anywhere in the module: on a CUDA tensor the kernel
    runs or the call raises."""
    _, _, att = tt
    tree = ast.parse(inspect.getsource(att))
    assert not [n for n in ast.walk(tree) if isinstance(n, ast.Try)]


@pytest.mark.parametrize("name", ["flash_attn_fwd", "flash_attn_bwd",
                                  "flash_attn_wide_fwd",
                                  "flash_attn_wide_bwd"])
def test_one_binding_matches_each_launchers_c_signature(tt, name,
                                                        monkeypatch):
    """``attention.bind``, the one binding of the launchers (used by the
    wrappers and by ``chip_smoke.py --parent``), sets the argument types
    of the launcher's extern "C" signature in its source, and the launch
    code shared by both (``_launch``, ``_launch_bwd``) passes each
    argument in the place of its name there."""
    import contextlib
    import ctypes
    import re
    import types
    torch, mt, att = tt
    src = (mt.build.CSRC_DIR / (att._SOURCE[name] + ".cu")).read_text()
    sig = re.search(r'extern "C" int %s\((.*?)\)' % name, src, re.S)
    params = [p.split() for p in sig.group(1).split(",")]
    names = [p[-1].lstrip("*") for p in params]
    types_ = [ctypes.c_void_p if "*" in "".join(p) else
              {"int": ctypes.c_int, "float": ctypes.c_float}[p[-2]]
              for p in params]
    calls = []

    def launcher(*args):
        calls.append(dict(zip(names, args)))
        return 0

    lib = types.SimpleNamespace(**{name: launcher,
                                   att._ERROR_STRING[name]: lambda rc: b""})
    kernel = att.bind(lib, name)
    assert kernel[0].argtypes == types_
    assert kernel[1].argtypes == [ctypes.c_int]
    monkeypatch.setattr(torch.cuda, "device",
                        lambda dev: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda dev=None: types.SimpleNamespace(
                            cuda_stream=1234))
    q = torch.zeros(2, 3, 5, 32)
    k, v = torch.zeros(2, 3, 7, 32), torch.ones(2, 3, 7, 32)
    want = dict(q=q.data_ptr(), k=k.data_ptr(), v=v.data_ptr(), bh=6,
                t_len=5, s_len=7, d=32, scale=0.5, causal=1, dtype=0,
                stream=1234)
    if name in (att.KERNEL, att.WIDE_KERNEL):
        out, lse = att._launch(kernel, q, k, v, True, 0.5, want_lse=True)
        want.update(o=out.data_ptr(), lse=lse.data_ptr())
    else:
        o, g, lse = q + 1, q + 2, torch.zeros(2, 3, 5)
        dq, dk, dv = att._launch_bwd(kernel, q, k, v, o, g, lse, True, 0.5)
        want.update(o=o.data_ptr(), dout=g.data_ptr(), lse=lse.data_ptr(),
                    dq=dq.data_ptr(), dk=dk.data_ptr(), dv=dv.data_ptr())
        assert calls[0]["delta"] not in want.values()  # its own scratch
        want["delta"] = calls[0]["delta"]
    assert calls == [want]
    assert sorted(want) == sorted(names)


def test_chip_smoke_counts_the_flash_bound_on_the_tensor_cores(tt):
    """chip_smoke's flash bound at the served shape (causal, H=12,
    T=S=1024, D=64): f32 as three TF32 passes at 495 TFLOP/s, bf16 by
    its bytes at 3.35 TB/s; the CUDA-core f32 figure beside."""
    torch = tt[0]
    import chip_smoke
    served = (12, 1024, 1024, 64, True)
    cases = [(4, torch.float32, 0.0391, "operations"),
             (1, torch.float32, 0.0098, "operations"),
             (4, torch.bfloat16, 0.0075, "bytes")]
    for b, dtype, want_ms, want_by in cases:
        ms, by = chip_smoke.attention_bound_ms(b, *served, dtype)
        assert by == want_by
        assert abs(ms - want_ms) < 5e-5, (b, dtype, ms)
    assert abs(chip_smoke.cuda_core_ms(4, *served) - 0.0962) < 5e-5


def test_chip_smoke_counts_the_backward_bound_at_each_types_peak(tt):
    """chip_smoke's flash backward bound at the LM's shape: the five
    products the gradient needs (16.12 GFLOP at B=4), f32 as three TF32
    passes at 495 TFLOP/s, bf16 at 989 TFLOP/s (above its 0.0151 ms of
    bytes); beside it the figure of the kernels' own route, their seven
    products (22.57 GFLOP) at the same peaks."""
    torch = tt[0]
    import chip_smoke
    served = (12, 1024, 1024, 64, True)
    assert abs(chip_smoke.backward_flops(4, *served) - 16.121856e9) < 1e3
    assert abs(chip_smoke.backward_flops(4, *served, products=7)
               - 22.5705984e9) < 1e3
    cases = [(4, torch.float32, 0.0977, "operations"),
             (1, torch.float32, 0.0244, "operations"),
             (4, torch.bfloat16, 0.0163, "operations")]
    for b, dtype, want_ms, want_by in cases:
        ms, by = chip_smoke.backward_bound_ms(b, *served, dtype)
        assert by == want_by
        assert abs(ms - want_ms) < 5e-5, (b, dtype, ms)
    for b, dtype, want_ms in [(4, torch.float32, 0.1368),
                              (4, torch.bfloat16, 0.0228),
                              (1, torch.float32, 0.0342)]:
        ms = chip_smoke.backward_route_ms(b, *served, dtype)
        assert abs(ms - want_ms) < 5e-5, (b, dtype, ms)


def _covered_by_bins(shape, rois, pooled, scale):
    """The map pixels (n, y, x) inside some bin of some ROI, marked bin by
    bin from ROIPooling's arithmetic in numpy float32: corners rint (half
    to even), extent max(x2 - x1 + 1, 1), bin size extent * float32(1 /
    pooled), bin p spanning [clip(floor(p * bin) + x1, 0, W - 1),
    clip(ceil((p + 1) * bin) + x1, 0, W)), a NaN bound empty; the image
    truncated and clamped into [0, N)."""
    f = np.float32
    N, _, H, W = shape
    hit = np.zeros((N, H, W), bool)

    def span(p, size, origin, n):
        lo = np.clip(np.floor(f(p) * size) + origin, 0, n - 1)
        hi = np.clip(np.ceil(f(p + 1) * size) + origin, 0, n)
        return (0, 0) if np.isnan(lo) or np.isnan(hi) else (int(lo),
                                                           int(hi))

    for roi in np.asarray(rois, f):
        b = 0 if np.isnan(roi[0]) else int(np.clip(np.trunc(roi[0]), 0,
                                                   N - 1))
        x1, y1, x2, y2 = (np.rint(c * f(scale)) for c in roi[1:])
        bin_h = max(y2 - y1 + f(1), f(1)) * (f(1) / f(pooled[0]))
        bin_w = max(x2 - x1 + f(1), f(1)) * (f(1) / f(pooled[1]))
        for ph in range(pooled[0]):
            hs, he = span(ph, bin_h, y1, H)
            for pw in range(pooled[1]):
                ws, we = span(pw, bin_w, x1, W)
                hit[b, hs:he, ws:we] = True
    return int(hit.sum())


def test_chip_smoke_counts_the_roi_bytes_these_inputs_need(tt):
    """chip_smoke's ROIPooling bound counts the map pixels that some bin
    covers, each channel once, as a bin-by-bin count does: on coinciding
    bins (ROIs under 7 pixels at 7x7), ROIs off the map (those past the
    bottom right clip to its corner pixel, those above the top left
    cover nothing), ROIs on both images, and the training shape; then the
    forward's bytes (those pixels, the ROIs, the max written) and the
    backward's (dy, those pixels and the ROIs read, the whole dx written)
    at 3.35 TB/s."""
    torch = tt[0]
    import chip_smoke
    rng = np.random.RandomState(5)
    coinciding = np.concatenate([
        rng.randint(0, 2, (6, 1)), rng.uniform(0, 20, (6, 2)),
        np.zeros((6, 2))], 1).astype(np.float32)
    coinciding[:, 3:] = coinciding[:, 1:3] + rng.uniform(0, 6, (6, 2))
    outside = np.array([[0, 30, 22, 41, 29], [1, -40, -30, -21, -19],
                        [0, 25, 1, 60, 9], [1, -30, 2, -4, 12],
                        [0, 2, 2, 6, 6]], np.float32)
    rng = np.random.RandomState(6)
    x1, y1 = rng.uniform(-4, 16, 10), rng.uniform(-4, 12, 10)
    both = np.stack([np.arange(10) % 2, x1, y1, x1 + rng.uniform(0, 12, 10),
                     y1 + rng.uniform(0, 10, 10)], 1).astype(np.float32)
    cases = [((2, 3, 9, 11), coinciding, (7, 7), 0.5),
             ((2, 2, 8, 10), outside, (3, 3), 0.5),
             ((2, 4, 12, 15), both, (2, 3), 1.0)]
    cfg = chip_smoke.ROI_TIMED
    data, rois, pooled, scale = chip_smoke.roi_inputs(
        16, cfg["rois"], cfg["channels"], cfg["shape"], cfg["image"],
        cfg["pooled"], device="cpu")
    cases.append((tuple(data.shape), rois.numpy(), pooled, scale))
    counts = []
    for shape, rois, pooled, scale in cases:
        want = _covered_by_bins(shape, rois, pooled, scale)
        counts.append(want)
        data = torch.zeros(shape)
        rois = torch.from_numpy(rois)
        assert chip_smoke.roi_covered(data, rois, pooled, scale) == want
        N, C, H, W = shape
        R = rois.shape[0]
        out = R * C * pooled[0] * pooled[1] * 4
        nb = chip_smoke.roi_bytes(data, rois, pooled, scale)
        assert nb["fwd"] == want * C * 4 + R * 20 + out
        assert nb["bwd"] == (out + want * C * 4 + R * 20
                             + N * C * H * W * 4)
        ms = chip_smoke.roi_bound_ms(data, rois, pooled, scale)
        assert ms[:2] == pytest.approx((nb["fwd"] / 3.35e9,
                                        nb["bwd"] / 3.35e9), rel=1e-12)
    # image 0: the corner pixel, column 9's rows 0-4, a 3x3 ROI; image 1's
    # ROIs above the top left cover nothing
    assert counts[1] == 1 + 5 + 9
    assert round(nb["covered_share"], 3) == 0.981  # the training shape


def test_chip_smoke_tells_the_roi_interfaces_apart(tmp_path):
    """``--parent`` binds an earlier roi_pooling.cu, whose forward also
    writes an int32 tie count, by the C signature in its source; this
    tree's forward writes the max alone."""
    import chip_smoke
    earlier = tmp_path / "roi_pooling.cu"
    earlier.write_text(
        "int roi_pool_forward(const void* data, const void* rois, void* "
        "out,\n                     void* count, int N, int C, int H, "
        "int W, int R, int PH,\n                     int PW, float scale, "
        "void* stream) {\n  return 0;\n}\n")
    assert chip_smoke.roi_takes_tie_count(str(earlier))
    assert not chip_smoke.roi_takes_tie_count(os.path.join(
        os.path.dirname(chip_smoke.__file__), "mxtpu_torch", "csrc",
        "roi_pooling.cu"))


def test_chip_smoke_reads_ptxas_per_instance():
    import chip_smoke
    log = (
        "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__92c96d0c"
        "_17_flash_attn_fwd_cu_cd4330bb16flash_fwd_kernelIfLi64EEEvPKT_S3_S3"
        "_PS1_iifii' for 'sm_90a'\n"
        "    0 bytes stack frame, 8 bytes spill stores, 4 bytes spill loads\n"
        "ptxas info    : Used 223 registers, used 1 barriers\n"
        "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__0_11rows"
        "_kernelI13__nv_bfloat16Lb1EEEvPKT_PKfS6_S4_PS2_ll' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 40 registers, used 0 barriers\n"
        "ptxas info    : Compiling entry function '_ZN50_GLOBAL__N__92c96d0c"
        "_17_flash_attn_fwd_cu_cd4330bb16flash_fwd_kernelIfLi64ELb0EEEvPKT_"
        "S3_S3_PS1_Pfiifii' for 'sm_90a'\n"
        "    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads\n"
        "ptxas info    : Used 220 registers, used 1 barriers\n")
    assert chip_smoke.ptxas_instances(log) == [
        ("flash_fwd_kernel<float, 64>", 223, 8, 4),
        ("rows_kernel<bf16, true>", 40, 0, 0),
        ("flash_fwd_kernel<float, 64, false>", 220, 0, 0)]


def _wide_ptxas_log(spill=None):
    """ptxas's report of the wide pair's forward, dK/dV and dQ instances
    in both types, unchunked and chunked, as nvcc prints it; the instance
    named ``spill`` (as ptxas_instances names it) spills 8 bytes."""
    log, names = "", []
    for kern in ("wide_fwd", "wide_dkdv", "wide_dq"):
        for typ, tname in (("f", "float"), ("13__nv_bfloat16", "bf16")):
            for chunked in (0, 1):
                name = "%s_kernel<%s, %s>" % (kern, tname,
                                               ("false", "true")[chunked])
                names.append(name)
                log += (
                    "ptxas info    : Compiling entry function '_ZN50_GLOBAL_"
                    "_N__0_18_flash_attn_wide_cu_0%d%s_kernelI%sLb%dEEEvPKT_"
                    "S3_S3_PS1_Pfiiifii' for 'sm_90a'\n    0 bytes stack "
                    "frame, %d bytes spill stores, 0 bytes spill loads\nptxas"
                    " info    : Used 181 registers, used 3 barriers\n"
                    % (len(kern) + 7, kern, typ, chunked,
                       8 if name == spill else 0))
    return log, names


def test_chip_smoke_names_the_wide_pairs_instances_as_ptxas_reports_them():
    """The wide pair's instances, which chip_smoke's build phase holds to
    no spills, parse out of ptxas's mangled entry names."""
    import chip_smoke
    log, names = _wide_ptxas_log()
    assert [row[0] for row in chip_smoke.ptxas_instances(log)] == names


@pytest.mark.parametrize("spill", [None, "wide_fwd_kernel<float, false>",
                                   "wide_dq_kernel<bf16, true>"])
def test_chip_smoke_holds_every_wide_instance_to_no_spills(monkeypatch,
                                                           spill):
    """check_flash_build refuses a spill in any instance of the wide pair,
    the chunked ones (D > 256) as well as those D <= 256 runs."""
    import types
    import chip_smoke
    log, _ = _wide_ptxas_log(spill)
    build = types.SimpleNamespace(
        build_log={"flash_attn_fwd": {"ptxas": ""},
                   "flash_attn_bwd": {"ptxas": ""},
                   "flash_attn_wide": {"ptxas": log}},
        _target=lambda name: (None, name))
    monkeypatch.setattr(chip_smoke, "sass_hmma", lambda path: 5)
    if spill is None:
        assert chip_smoke.check_flash_build(build) == {
            "flash_attn_fwd": 5, "flash_attn_bwd": 5, "flash_attn_wide": 5}
    else:
        with pytest.raises(AssertionError, match="spills"):
            chip_smoke.check_flash_build(build)


@pytest.mark.parametrize("d,blocks,fwd,bwd", [
    (129, 1, 1.0, 1.4), (256, 1, 1.0, 1.4), (257, 2, 1.5, 2.2),
    (640, 3, 2.0, 3.0), (1024, 4, 2.5, 3.8)])
def test_chip_smoke_counts_the_wide_pairs_route_with_its_recompute(
        d, blocks, fwd, bwd):
    """The wide pair's route figure: each of its Z column blocks (the
    kernel reports Z = ceil(D / 256); the card's tests hold it to that)
    recomputes the scores over all of D (and dP, in both backward
    kernels), so the forward does (Z + 1) / 2 times the forward's 4 D
    flops a pair, and the backward (4 Z + 3) / 5 times the 5 products; at
    Z = 1 the 7-product route of the D <= 128 backward."""
    import chip_smoke
    shape = (4, 8, 1024, 1024, d, True)
    ratio = (chip_smoke.wide_route_flops(*shape, blocks)
             / chip_smoke.attention_flops(*shape))
    bwd_ratio = (chip_smoke.wide_route_flops(*shape, blocks, backward=True)
                 / chip_smoke.backward_flops(*shape))
    assert abs(ratio - fwd) < 1e-12 and abs(bwd_ratio - bwd) < 1e-12
    if blocks == 1:
        assert chip_smoke.wide_route_flops(*shape, blocks, backward=True) \
            == chip_smoke.backward_flops(*shape, products=7)


def _tf32(torch, x):
    """f32 rounded to TF32 (10 stored mantissa bits): to nearest, ties away
    from zero, on the low 13 bits, as cvt.rna.tf32.f32 rounds."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def _tf32_matmul(torch, a, b, passes):
    """a @ b as the kernel's tensor cores form it from f32 operands: one
    TF32 pass (big*big), or 3xTF32 (small*big + big*small + big*big with
    x = big + small, both TF32); every product is exact in f32."""
    ab, bb = _tf32(torch, a), _tf32(torch, b)
    if passes == 1:
        return ab @ bb
    a_small, b_small = _tf32(torch, a - ab), _tf32(torch, b - bb)
    return a_small @ bb + ab @ b_small + ab @ bb


def _emulated_kernel(torch, q, k, v, causal, passes, block=64):
    """The f32 arithmetic of csrc/flash_attn_fwd.cu: kv tiles of 64 keys,
    an online softmax in f32, q.k^T and p.v on TF32 operands."""
    t = q.shape[2]
    scale = q.shape[-1] ** -0.5
    m = torch.full(q.shape[:3] + (1,), float("-inf"))
    l = torch.zeros_like(m)
    acc = torch.zeros(q.shape)
    rows = torch.arange(t)[:, None]
    for k0 in range(0, k.shape[2], block):
        kc, vc = k[:, :, k0:k0 + block], v[:, :, k0:k0 + block]
        s = _tf32_matmul(torch, q, kc.transpose(-1, -2), passes) * scale
        if causal:
            cols = torch.arange(k0, k0 + kc.shape[2])
            s = s.masked_fill(cols[None, :] > rows, float("-inf"))
        m_new = torch.maximum(m, s.amax(dim=-1, keepdim=True))
        m_use = torch.where(m_new == float("-inf"), 0.0, m_new)
        p = torch.exp(s - m_use)
        alpha = torch.exp(m - m_use)
        l = alpha * l + p.sum(dim=-1, keepdim=True)
        acc = acc * alpha + _tf32_matmul(torch, p, vc, passes)
        m = m_new
    return acc / torch.where(l == 0, 1.0, l)


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_keeps_the_f32_gate_where_one_tf32_pass_does_not(tt, causal):
    """Why the f32 kernel runs 3xTF32: emulated on the CPU at D=64,
    T=S=256, the 3xTF32 result stays within chip_smoke's 2e-4 gate against
    the plain version, and one TF32 pass breaks it."""
    torch, _, att = tt
    rng = np.random.RandomState(0)
    q, k, v = (torch.from_numpy(rng.randn(1, 2, 256, 64).astype(np.float32))
               for _ in range(3))
    want = att.flash_attention_reference(q, k, v, causal=causal)
    err3 = (_emulated_kernel(torch, q, k, v, causal, 3) - want).abs().max()
    err1 = (_emulated_kernel(torch, q, k, v, causal, 1) - want).abs().max()
    assert err3.item() <= 2e-4
    assert err1.item() > 2e-4
    assert err1.item() > 100 * err3.item()


@pytest.mark.parametrize("causal", [False, True])
def test_3xtf32_keeps_the_backward_gate_where_one_tf32_pass_does_not(
        tt, causal):
    """Why the f32 backward runs 3xTF32: emulated on the CPU at D=64,
    T=S=256, the 3xTF32 gradients stay within chip_smoke's BWD_TOL (1e-4
    of max(1, |plain|)) of the plain version, and one TF32 pass breaks
    it."""
    torch, _, att = tt
    import chip_smoke
    tol = chip_smoke.BWD_TOL[torch.float32]
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(1, 2, 256, 64)
                                   .astype(np.float32)) for _ in range(4))
    out, lse = att.flash_attention_reference(q, k, v, causal=causal,
                                             return_lse=True)
    want = att.flash_attention_backward_reference(q, k, v, out, g, lse,
                                                  causal=causal)

    def err(passes):
        got = chip_smoke.emulated_backward(q, k, v, out, g, lse, causal,
                                           passes)
        return max(chip_smoke.rel_err(a, w) for a, w in zip(got, want))

    err3, err1 = err(3), err(1)
    assert err3 <= tol
    assert err1 > tol
    assert err1 > 100 * err3


def test_truncating_mma_accumulation_accounts_for_the_backward_error(tt):
    """Where the f32 backward's error against the plain version comes
    from: at the LM's causal T=S=1024 and D=64, the 3xTF32 emulation
    reads about 1e-6 (scaled) when each MMA rounds its f32 sum to nearest,
    and over ten times that when the sum is truncated as the tensor cores
    truncate it (chip_smoke phase 3c holds the kernel against both
    models); truncated, it is still inside BWD_TOL."""
    torch, _, att = tt
    import chip_smoke
    tol = chip_smoke.BWD_TOL[torch.float32]
    rng = np.random.RandomState(0)
    q, k, v, g = (torch.from_numpy(rng.randn(1, 1, 1024, 64)
                                   .astype(np.float32)) for _ in range(4))
    out, lse = att.flash_attention_reference(q, k, v, causal=True,
                                             return_lse=True)
    want = att.flash_attention_backward_reference(q, k, v, out, g, lse,
                                                  causal=True)

    def err(acc):
        got = chip_smoke.emulated_backward(q, k, v, out, g, lse, True, 3,
                                           acc)
        return max(chip_smoke.rel_err(a, w) for a, w in zip(got, want))

    rn, tc = err("rn"), err("tc")
    assert rn < 2e-6
    assert tc > 10 * rn
    assert tc <= tol
