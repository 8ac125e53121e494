"""The port's CUDA kernels on the card, against their plain versions:
flash attention within 2e-4 (f32, 3xTF32 on the tensor cores) and 2e-2
(bf16) at the edges of its 64-row tiles, every head dim, no keys, and
storage offsets; its log-sum-exp within 1e-4; the flash backward within
1e-4 (f32) and 2e-2 (bf16) of max(1, |plain|) at the edges of its 16-
and 64-row tiles, every head dim, no keys, unaligned storage and NaN
stored past the ends, bit-identical when repeated; the
BN-apply+ReLU epilogue bit for bit (NaN positions included) at
ResNet-50's served shapes; a Module training step on gpu(0) against
the same step on cpu(); BatchNorm in training on the card against the
CPU; DevicePrefetchIter staging behind a delayed side stream; a Gluon
SGD step of a narrow ResNetV2 on the card against its CPU step, the
hybridized evaluation forward launching the epilogue once per fused site
and equal to its plain version, and CUDA nd arrays staying on the card;
the KVStore on CUDA values bit for bit against the host's sums and
SGD; and, with two cards or more (skipped below), the KVStore over the
cards, every kernel on every card against its plain version there, and
a Module over [gpu(0), gpu(1)] against gpu(0) on the whole batch with
bit-identical replicas; the mesh collectives (NCCL reduce-scatter and
all-gather, peer-copy ppermute and all-to-all) against the host's
arithmetic, and ``fit(mesh=n)`` from gpu(0) against the replicated
fused path over the cards; with four cards (skipped below), ring and
Ulysses attention, whose every hop is a flash kernel launch, against the
same functions on cpu() contexts, where every hop is the plain version.
The RNN op's cuDNN route against the plain loop on the card, its clip
route and its refusal; a BucketingModule step on gpu(0) against cpu();
with two cards, group2ctx placement against one card. ``Embedding`` on
ids outside its range leaving the CUDA context usable; the MultiBox
suppression kernel bit for bit against its plain version on every set
of ``models.ssd_data.nms_sets`` (one class overlapping, IoUs at the
threshold, -inf tails, force_suppress, NaN boxes, K = 1, 37, 400,
1,376, dead scores between live ones) and at K = 1,757, 2,048, 7,486
(all live and 50 live) and 24,564, its refusals, and the tiny SSD's
training step on gpu(0) against cpu() with the kernel launched once a
step. The flash forward and backward at head dims 16, 48, 80, 96 and
112, which the wrappers pad to the kernel's next width, and at 129, 160,
192, 256, 512, 513, 640 and 1024, which take the wide pair unpadded
(above 256 split into 256-column blocks), with unaligned storage too.
The record pipeline feeding the card: ``ImageRecordIter`` through
``ResizeIter`` into ``Module.fit`` of a resnet-18 on gpu(0) with
``Accuracy`` and ``TopKAccuracy``, its evaluation forward on a record
batch launching the epilogue once per fused site and equal to the plain
epilogue; ``TopKAccuracy`` accumulated on the card equal to its host
sum; ``ImageDetRecordIter`` into the tiny SSD's ``fit`` with the
suppression kernel launched once a step. ROADMAP C.8-C.13 and A.14 on
CUDA tensors against cpu(): the relu/abs/power gradients at ties and
zeros, integer and float16/bfloat16 scalar arithmetic and reductions
(uint32 sums read back), numpy dtypes in and out of the constructors;
each new optimizer's 4 updates (float16 weights through SGD's
multi_precision) and the MAE/MSE/RMSE/Loss device kernels; SGLD's
noise, every sampler and ``multinomial`` by their moments. A.7's
tensor/nn tranche: every case of ``op_tranche_cases.py`` on CUDA tensors
against cpu() (forward and gradient), indices far out of range leaving
the context usable, the NDArray surface (``%``, ``clip``, ``dot``,
``topk``), Gluon's ``Conv2DTranspose``; A.15's Gluon zoo nets on the card
against cpu(). A.7's second tranche: the ROIPooling kernel against its
plain version on the same card tensors (forward bit for bit, backward
within 1e-6 of the largest and bit-identical on repeat) at every case of
``spatial_cases.py`` and at the Faster R-CNN's training shape, the
forward at the test forward's 600 ROIs, the backward bit for bit with
the sum in (ROI, ph, pw) order where a pixel is in thousands of bins,
and its refusals; Proposal with the suppression kernel against the plain
Proposal on the same card inputs, bit for bit, at K = 12,000 and 6,000;
every spatial case on CUDA tensors against cpu(); a Custom op and the
update ops on the card; the example Faster R-CNN's step on gpu(0). A.7's
last names and A.4.3: every linalg and contrib case of
``final_op_cases.py`` on CUDA tensors against cpu(); the CTC kernel pair
against its plain version on the same card tensors at every CTC case, a
speech shape, 3,000 classes and 2,201 states, and its refusals; Gluon's
CTCLoss on gpu(0) against cpu(); the sparse dots and a row_sparse pull
on the card. A.4's rest: the subgroup collectives (all-reduce,
all-gather and reduce-scatter within the groups of a 2-D layout, along
any dimension) on NCCL against the host's sums; with four cards, a
``data:2,tp:2`` and a ``data:2,fsdp:2`` fit of the mlp from gpu(0)
against the same fit over cpu(0..3); ``dist_async`` between two
processes on gpu(0) with rank 0 serving. A.8: ``nd.waitall()`` with
gpu(0) current waiting for a long kernel on cuda:3 (ROADMAP C.20, four
cards), and a small LM's fit launching the same flash kernels with
telemetry on and off. A.10: a CUDA fit's health rows against float64
and its metric syncs equal a health-off fit's; the fused update with
health armed bit for bit the unarmed one; the ledger's reconcile drift
after a step; the watchdog firing on a CUDA-event wait held by an
injected latency.

Marked ``cuda``: each test skips without a CUDA device (decided inside
the test). Run them on a machine with an H100 — which has no JAX, so the
repository's conftest.py (which imports JAX) is left out:

    python -m pytest --noconftest -p no:cacheprovider tests/test_torch_cuda.py
"""
import pytest

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    from mxtpu_torch.ops import attention as att
    return torch, att


@pytest.fixture
def epi():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from mxtpu_torch.ops import epilogue
    return torch, epilogue


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("b,h,t,s,d", [
    (1, 1, 1, 1, 64), (1, 3, 33, 33, 32), (2, 2, 127, 129, 64),
    (1, 2, 200, 70, 128), (1, 1, 300, 1000, 64), (3, 1, 64, 2048, 32)] + [
    (2, 3, t, s, d) for d in (32, 64, 128)  # T < S, T > S, T = S
    for t, s in ((65, 129), (129, 63), (200, 200))])
def test_flash_kernel_matches_plain_version(cuda, dtype, tol, causal, b, h,
                                            t, s, d):
    torch, att = cuda
    g = torch.Generator(device="cuda").manual_seed(t * s + d)
    dt = getattr(torch, dtype)
    q = torch.randn(b, h, t, d, device="cuda", generator=g).to(dt)
    k = torch.randn(b, h, s, d, device="cuda", generator=g).to(dt)
    v = torch.randn(b, h, s, d, device="cuda", generator=g).to(dt)
    before = att.flash_attention.launches
    got = att.flash_attention(q, k, v, causal=causal, sm_scale=0.3)
    want = att.flash_attention_reference(q, k, v, causal=causal,
                                         sm_scale=0.3)
    torch.cuda.synchronize()
    assert att.flash_attention.launches == before + 1
    assert got.dtype == dt and got.shape == q.shape
    assert (got.float() - want.float()).abs().max().item() <= tol


def _flash_case(torch, att, shape_q, shape_kv, dt, causal, seed, offset=0,
                counter="launches"):
    """q, k, v of the given shapes (each a contiguous view ``offset``
    elements into its storage), held to the plain version within 2e-4
    (float32) or 2e-2 (bfloat16), one count of ``flash_attention.<counter>``;
    returns the kernel's output."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def make(shape):
        n = 1
        for x in shape:
            n *= x
        buf = torch.randn(n + offset, device="cuda", generator=g).to(dt)
        return buf[offset:].view(shape)

    q, k, v = make(shape_q), make(shape_kv), make(shape_kv)
    before = getattr(att.flash_attention, counter)
    got = att.flash_attention(q, k, v, causal=causal)
    want = att.flash_attention_reference(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert getattr(att.flash_attention, counter) == before + 1
    assert got.dtype == dt and got.shape == q.shape
    tol = 2e-4 if dt == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol
    return got


EDGES = [1, 63, 64, 65, 127, 129]  # around the 64-row q and kv tiles


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", EDGES)
@pytest.mark.parametrize("t", EDGES)
def test_flash_kernel_tile_edges(cuda, dtype, causal, t, s):
    """Partial q and kv tiles, a single key, and causal with T < S and
    T > S (top-left aligned)."""
    torch, att = cuda
    _flash_case(torch, att, (1, 2, t, 64), (1, 2, s, 64),
                getattr(torch, dtype), causal, seed=t * 1000 + s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_kernel_without_keys_gives_zero(cuda, dtype, causal):
    torch, att = cuda
    out = _flash_case(torch, att, (1, 2, 70, 64), (1, 2, 0, 64),
                      getattr(torch, dtype), causal, seed=1)
    assert not out.float().abs().max().item()


@pytest.mark.parametrize("dtype,offset", [
    ("float32", 4), ("float32", 12), ("bfloat16", 8), ("bfloat16", 24),
    ("float32", 1), ("bfloat16", 1)])
def test_flash_kernel_storage_offsets(cuda, dtype, offset):
    """q, k, v 16 or 48 bytes into their storage: 16-byte aligned but not
    128-byte aligned (the cp.async path); one element in, not 16-byte
    aligned (plain loads)."""
    torch, att = cuda
    _flash_case(torch, att, (2, 2, 130, 64), (2, 2, 190, 64),
                getattr(torch, dtype), True, seed=offset, offset=offset)


def test_nan_past_the_kv_tail_never_leaks(cuda):
    """Rows past S in the same allocation are never read."""
    torch, att = cuda
    buf = torch.full((1, 1, 80, 64), float("nan"), device="cuda")
    buf[:, :, :70] = torch.randn(1, 1, 70, 64, device="cuda")
    k = buf[:, :, :70]  # contiguous prefix of a NaN-tailed buffer
    q = torch.randn(1, 1, 16, 64, device="cuda")
    out = att.flash_attention(q, k, k)
    assert torch.isfinite(out).all()


@pytest.mark.parametrize("case", ["float16", "non_contiguous",
                                  "unequal_head_dims"])
def test_kernel_refuses_what_it_does_not_take(cuda, case):
    torch, att = cuda
    from mxtpu_torch import MXNetError
    q = torch.zeros(1, 2, 8, 64, device="cuda")
    k = torch.zeros_like(q)
    if case == "float16":
        q, k = q.half(), k.half()
    elif case == "non_contiguous":
        q = torch.zeros(1, 8, 2, 64, device="cuda").transpose(1, 2)
    else:  # every head dim runs; q's and k's must agree
        q = torch.zeros(1, 2, 8, 513, device="cuda")
    before = (att.flash_attention.launches,
              att.flash_attention.wide_launches)
    with pytest.raises(MXNetError, match="head dims differ"
                       if case == "unequal_head_dims" else None):
        att.flash_attention(q, k, k)
    assert (att.flash_attention.launches,
            att.flash_attention.wide_launches) == before


PADDED_HEAD_DIMS = [16, 48, 80, 96, 112]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", PADDED_HEAD_DIMS)
def test_flash_kernel_takes_every_head_dim_up_to_128(cuda, dtype, causal, d):
    """Head dims the kernel is not built for: the wrapper pads q, k, v to
    the next of 32, 64, 128 and slices the output back (one launch)."""
    torch, att = cuda
    out = _flash_case(torch, att, (2, 3, 130, d), (2, 3, 70, d),
                      getattr(torch, dtype), causal, seed=d)
    assert out.is_contiguous()


WIDE_HEAD_DIMS = [129, 160, 192, 256, 512, 513, 640, 1024]
WIDE_SHAPES = [(65, 129), (129, 63), (200, 200), (17, 0)]  # T<S, T>S, S=0


@pytest.mark.parametrize("dtype,tol", [("float32", 2e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("t,s", WIDE_SHAPES)
def test_wide_flash_forward_matches_plain_version(cuda, dtype, tol, causal,
                                                  d, t, s):
    """Head dims above 128 go unpadded to the wide kernel: one counted wide
    launch and none of the tensor-core kernel; output within the D <= 128
    cases' tolerances of the plain version, its lse within 1e-4 (+inf at
    the same rows)."""
    torch, att = cuda
    g = torch.Generator(device="cuda").manual_seed(t * s + d)
    dt = getattr(torch, dtype)
    q = torch.randn(2, 3, t, d, device="cuda", generator=g).to(dt)
    k = torch.randn(2, 3, s, d, device="cuda", generator=g).to(dt)
    v = torch.randn(2, 3, s, d, device="cuda", generator=g).to(dt)
    before = (att.flash_attention.launches,
              att.flash_attention.wide_launches)
    got = att.flash_attention(q, k, v, causal=causal)
    got_o, got_lse = att._flash_cuda(q, k, v, causal, d ** -0.5,
                                     want_lse=True)
    want, lse = att.flash_attention_reference(q, k, v, causal=causal,
                                              return_lse=True)
    torch.cuda.synchronize()
    assert (att.flash_attention.launches,
            att.flash_attention.wide_launches) == (before[0], before[1] + 2)
    assert got.dtype == dt and got.shape == q.shape
    assert torch.equal(got, got_o)
    assert (got.float() - want.float()).abs().max().item() <= tol
    fin = torch.isfinite(lse)
    assert torch.equal(torch.isfinite(got_lse), fin)
    if bool(fin.any()):
        assert (got_lse[fin] - lse[fin]).abs().max().item() <= 1e-4
    if s == 0:
        assert not got.float().abs().max().item()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
@pytest.mark.parametrize("t,s", WIDE_SHAPES)
def test_wide_flash_backward_matches_plain_version(cuda, dtype, causal, d, t,
                                                   s):
    """The wide backward at D > 128: within 1e-4 (float32) or 2e-2
    (bfloat16) of max(1, |plain|), bit-identical on repeat, NaN past every
    end never read, one counted wide launch a call."""
    torch, att = cuda
    got = _bwd_case(torch, att, t, s, d, getattr(torch, dtype), causal,
                    seed=7 * t + s + d, tail=64, b=2, h=3)
    assert all(x.shape[-1] == d and bool(torch.isfinite(x).all())
               for x in got)


@pytest.mark.parametrize("dtype,offset", [("float32", 1), ("float32", 2),
                                          ("bfloat16", 1), ("bfloat16", 4)])
@pytest.mark.parametrize("d", [129, 256])
def test_wide_flash_storage_offsets(cuda, dtype, offset, d):
    """The wide pair on views 4 to 8 bytes into their storage (not 16-byte
    aligned: 4-byte copies in float32, plain loads in bfloat16), causal,
    T != S: the forward within 2e-4 / 2e-2 of the plain version and the
    backward held as above, NaN before and past every view."""
    torch, att = cuda
    dt = getattr(torch, dtype)
    _flash_case(torch, att, (1, 2, 70, d), (1, 2, 97, d), dt, True,
                seed=d + offset, offset=offset, counter="wide_launches")
    _bwd_case(torch, att, 70, 97, d, dt, True, seed=d * offset,
              offset=offset, tail=64)


def test_wide_flash_autograd_on_the_card(cuda):
    """FlashAttentionFunction at D=256 runs the wide forward and backward
    once each and neither tensor-core kernel."""
    torch, att = cuda
    q = torch.randn(1, 2, 100, 256, device="cuda", requires_grad=True)
    count = (lambda: (att.flash_attention.launches,
                      att.flash_attention_backward.launches,
                      att.flash_attention.wide_launches,
                      att.flash_attention_backward.wide_launches))
    before = count()
    out = att.flash_attention(q, q, q, causal=True)
    out.sum().backward()
    torch.cuda.synchronize()
    assert count() == (before[0], before[1], before[2] + 1, before[3] + 1)
    assert bool(torch.isfinite(q.grad).all())


@pytest.mark.parametrize("d", WIDE_HEAD_DIMS)
def test_wide_tiling_reports_the_column_blocks(cuda, d):
    """flash_attn_wide_tiling, which chip_smoke.py's route figures and
    block counts read: one column block a 256-column chunk of D, whole
    16-row tiles, in both types and directions; d = 0 refused."""
    import chip_smoke
    import mxtpu_torch as mt
    torch, _ = cuda
    for dtype in (torch.float32, torch.bfloat16):
        for backward in (False, True):
            tiling = chip_smoke.wide_tiling(mt, d, dtype, backward)
            assert tiling["columns"] == 256
            assert tiling["blocks"] == -(-d // 256)
            assert tiling["rows"] % 16 == 0 and tiling["rows"] > 0
    with pytest.raises(AssertionError, match="refuses"):
        chip_smoke.wide_tiling(mt, 0, torch.float32)


def _epilogue_inputs(torch, shape, axis, dtype, residual, seed):
    g = torch.Generator(device="cuda").manual_seed(seed)
    c = shape[axis]
    x = (torch.randn(shape, device="cuda", generator=g) * 2).to(dtype)
    r = torch.randn(shape, device="cuda", generator=g).to(dtype) \
        if residual else None
    scale = torch.rand(c, device="cuda", generator=g) + 0.5
    shift = torch.randn(c, device="cuda", generator=g) * 0.5
    return x, scale, shift, r


def _same_bits(torch, got, want):
    """Equal values, NaN at the same places (NaN payloads aside)."""
    nan = torch.isnan(want)
    assert torch.equal(torch.isnan(got), nan)
    assert torch.equal(got[~nan], want[~nan])


# phase 3b of chip_smoke.py: the ResNet-50 bucket-32 sites, channel-minor
# and NCHW, a ragged M, C = 37
EPILOGUE_CASES = [((401408, 64), -1), ((1568, 2048), -1),
                  ((32, 64, 112, 112), 1), ((32, 2048, 7, 7), 1),
                  ((1000, 72), -1), ((999, 37), -1), ((3, 37, 5, 7), 1),
                  ((2, 5, 7, 37), 3)]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", EPILOGUE_CASES,
                         ids=["x".join(map(str, s)) + "-ax%d" % a
                              for s, a in EPILOGUE_CASES])
def test_epilogue_kernel_equals_plain_version(epi, shape, axis, dtype,
                                              residual):
    torch, e = epi
    x, s, b, r = _epilogue_inputs(torch, shape, axis, getattr(torch, dtype),
                                  residual, seed=sum(shape))
    before = e.bn_apply_relu_add.launches
    got = e.bn_apply_relu_add(x, s, b, r, axis=axis)
    want = e.bn_apply_relu_add_reference(x, s, b, r, axis=axis)
    torch.cuda.synchronize()
    assert e.bn_apply_relu_add.launches == before + 1
    assert got.dtype == x.dtype and got.shape == x.shape
    _same_bits(torch, got, want)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((257, 40), -1), ((2, 6, 9, 9), 1)])
def test_epilogue_nan_and_inf_pass_as_in_the_plain_version(epi, shape, axis,
                                                           dtype):
    torch, e = epi
    x, s, b, r = _epilogue_inputs(torch, shape, axis, getattr(torch, dtype),
                                  True, seed=3)
    flat = x.view(-1)
    flat[::7] = float("nan")
    flat[3::11] = float("inf")
    flat[5::13] = float("-inf")
    got = e.bn_apply_relu_add(x, s, b, r, axis=axis)
    want = e.bn_apply_relu_add_reference(x, s, b, r, axis=axis)
    _same_bits(torch, got, want)
    assert torch.isnan(got).any() and torch.isinf(got).any()


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("shape,axis", [((300, 16), -1), ((4, 8, 10, 10), 1)])
def test_epilogue_unaligned_views_take_the_scalar_path(epi, shape, axis,
                                                       dtype):
    """A contiguous view one element into its storage is not 16-byte
    aligned: the kernel runs without vectors and still agrees."""
    torch, e = epi
    dt = getattr(torch, dtype)
    n = 1
    for d in shape:
        n *= d
    buf = torch.randn(n + 1, device="cuda").to(dt)
    x = buf[1:].view(shape)
    c = shape[axis]
    s = torch.rand(c, device="cuda") + 0.5
    b = torch.randn(c, device="cuda")
    _same_bits(torch, e.bn_apply_relu_add(x, s, b, x, axis=axis),
               e.bn_apply_relu_add_reference(x, s, b, x, axis=axis))


@pytest.mark.parametrize("case", ["float16", "non_contiguous", "cpu_scale",
                                  "scale_bf16"])
def test_epilogue_kernel_refuses_what_it_does_not_take(epi, case):
    torch, e = epi
    from mxtpu_torch import MXNetError
    x = torch.zeros(8, 4, device="cuda")
    s = torch.ones(4, device="cuda")
    if case == "float16":
        x = x.half()
    elif case == "non_contiguous":
        x = torch.zeros(4, 8, device="cuda").t()
    elif case == "cpu_scale":
        s = torch.ones(4)
    else:
        s = s.bfloat16()
    before = e.bn_apply_relu_add.launches
    with pytest.raises(MXNetError):
        e.bn_apply_relu_add(x, s, torch.zeros(4, device="cuda"))
    assert e.bn_apply_relu_add.launches == before


def _scaled_err(torch, got, want):
    if want.numel() == 0:
        return 0.0
    return ((got.float() - want.float()).abs().max()
            / want.float().abs().max().clamp(min=1.0)).item()


@pytest.mark.parametrize("dtype,tol", [("float32", 1e-4),
                                       ("bfloat16", 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,s,d", [(1, 1, 64), (63, 65, 64), (64, 64, 32),
                                   (65, 63, 64), (129, 129, 128),
                                   (200, 70, 32), (70, 200, 128),
                                   (64, 0, 64)])
def test_flash_backward_kernel_matches_plain_version(cuda, dtype, tol,
                                                     causal, t, s, d):
    torch, att = cuda
    g = torch.Generator(device="cuda").manual_seed(7 * t + s + d)
    dt = getattr(torch, dtype)
    q, k, v, do = (torch.randn(2, 3, n, d, device="cuda", generator=g)
                   .to(dt) for n in (t, s, s, t))
    out, lse = att.flash_attention_reference(q, k, v, causal=causal,
                                             return_lse=True)
    got_o, got_lse = att._flash_cuda(q, k, v, causal, d ** -0.5,
                                     want_lse=True)
    fin = torch.isfinite(lse)
    assert torch.equal(torch.isfinite(got_lse), fin)
    if bool(fin.any()):
        assert (got_lse[fin] - lse[fin]).abs().max().item() <= 1e-4
    before = att.flash_attention_backward.launches
    got = att.flash_attention_backward(q, k, v, out, do, lse, causal=causal)
    want = att.flash_attention_backward_reference(q, k, v, out, do, lse,
                                                  causal=causal)
    torch.cuda.synchronize()
    assert att.flash_attention_backward.launches == before + 1
    for a, w in zip(got, want):
        assert a.dtype == dt and a.shape == w.shape
        assert _scaled_err(torch, a, w) <= tol


def _bwd_case(torch, att, t, s, d, dt, causal, seed, offset=0, tail=0,
              b=1, h=2):
    """The backward kernel on q, k, v, dO that are each a contiguous view
    ``offset`` elements into a buffer holding NaN before and ``tail``
    elements after it (the lse likewise), held to the plain version
    within 1e-4 (float32) or 2e-2 (bfloat16) of max(1, |plain|), and a
    second call held to the first bit for bit."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def make(shape, dtype, fill=None):
        n = 1
        for x in shape:
            n *= x
        buf = torch.full((offset + n + tail,), float("nan"), device="cuda",
                         dtype=dtype)
        buf[offset:offset + n] = (torch.randn(n, device="cuda", generator=g)
                                  if fill is None else fill.reshape(-1))
        return buf[offset:offset + n].view(shape)

    q, k, v, do = (make((b, h, n, d), dt) for n in (t, s, s, t))
    out, lse = att.flash_attention_reference(q, k, v, causal=causal,
                                             return_lse=True)
    lse = make(lse.shape, torch.float32, fill=lse)
    counter = "wide_launches" if d > 128 else "launches"  # D > 128: wide
    before = getattr(att.flash_attention_backward, counter)
    got = att.flash_attention_backward(q, k, v, out, do, lse, causal=causal)
    again = att.flash_attention_backward(q, k, v, out, do, lse,
                                         causal=causal)
    want = att.flash_attention_backward_reference(q, k, v, out, do, lse,
                                                  causal=causal)
    torch.cuda.synchronize()
    assert getattr(att.flash_attention_backward, counter) == before + 2
    tol = 1e-4 if dt == torch.float32 else 2e-2
    for a, r, w in zip(got, again, want):
        assert a.dtype == dt and a.shape == w.shape
        assert _scaled_err(torch, a, w) <= tol
        assert torch.equal(a, r)
    return got


BWD_EDGES = [1, 15, 16, 17, 63, 64, 65, 127, 129]  # 16-row warp, 64-row tiles


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("s", BWD_EDGES)
@pytest.mark.parametrize("t", BWD_EDGES)
def test_flash_backward_tile_edges(cuda, dtype, causal, t, s):
    """Partial warp and block tiles on both sides, T != S under the
    causal mask (top-left aligned), a single row or key."""
    torch, att = cuda
    _bwd_case(torch, att, t, s, 64, getattr(torch, dtype), causal,
              seed=t * 1000 + s)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", [32, 64, 128])
@pytest.mark.parametrize("t,s", [(17, 15), (65, 129), (129, 63), (200, 200),
                                 (64, 0), (1, 0)])
def test_flash_backward_head_dims(cuda, dtype, causal, d, t, s):
    """Every head dim (D=128 streams 32-row tiles), and S = 0, where dq
    is 0 and dk, dv are empty."""
    torch, att = cuda
    dq, dk, dv = _bwd_case(torch, att, t, s, d, getattr(torch, dtype),
                           causal, seed=7 * t + s + d, b=2, h=3)
    if s == 0:
        assert not dq.float().abs().max().item()
        assert dk.numel() == dv.numel() == 0


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("d", PADDED_HEAD_DIMS)
def test_flash_backward_takes_every_head_dim_up_to_128(cuda, dtype, causal,
                                                       d):
    """The backward at head dims the kernel is not built for: q, k, v, out
    and dO padded, dq, dk, dv sliced back, one counted launch a call."""
    torch, att = cuda
    got = _bwd_case(torch, att, 65, 129, d, getattr(torch, dtype), causal,
                    seed=d, b=2, h=3)
    assert all(g.shape[-1] == d and g.is_contiguous() for g in got)


@pytest.mark.parametrize("dtype,offset", [
    ("float32", 4), ("bfloat16", 8), ("float32", 1), ("bfloat16", 1),
    ("float32", 3), ("bfloat16", 5)])
@pytest.mark.parametrize("causal", [False, True])
def test_flash_backward_storage_offsets(cuda, dtype, offset, causal):
    """Views 16 bytes into their storage (the cp.async path) and views
    that are not 16-byte aligned (plain loads into the same ring)."""
    torch, att = cuda
    _bwd_case(torch, att, 130, 190, 64, getattr(torch, dtype), causal,
              seed=offset, offset=offset)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("t,s,d", [(65, 129, 64), (129, 65, 64),
                                   (33, 70, 128), (70, 33, 32)])
def test_flash_backward_nan_past_the_ends_never_leaks(cuda, dtype, causal, t,
                                                      s, d):
    """NaN stored past the end of q, k, v, dO and lse (and, at offset 1,
    before them) is never read: the gradients stay finite and agree."""
    torch, att = cuda
    got = _bwd_case(torch, att, t, s, d, getattr(torch, dtype), causal,
                    seed=t + s, tail=4096)
    assert all(bool(torch.isfinite(x).all()) for x in got)
    _bwd_case(torch, att, t, s, d, getattr(torch, dtype), causal,
              seed=t + s + 1, offset=1, tail=64)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_backward_is_bit_identical_on_repeat(cuda, dtype):
    """No atomics: at the LM's shape (causal, H=12, T=S=1024, D=64) five
    calls give the same dq, dk and dv bit for bit."""
    torch, att = cuda
    dt = getattr(torch, dtype)
    g = torch.Generator(device="cuda").manual_seed(3)
    q, k, v, do = (torch.randn(1, 12, 1024, 64, device="cuda", generator=g)
                   .to(dt) for _ in range(4))
    out, lse = att._flash_cuda(q, k, v, True, 0.125, want_lse=True)
    first = att.flash_attention_backward(q, k, v, out, do, lse, causal=True)
    for _ in range(4):
        again = att.flash_attention_backward(q, k, v, out, do, lse,
                                             causal=True)
        assert all(torch.equal(a, b) for a, b in zip(first, again))


def test_flash_autograd_on_the_card_runs_both_kernels(cuda):
    torch, att = cuda
    q = torch.randn(1, 2, 100, 64, device="cuda", requires_grad=True)
    before = (att.flash_attention.launches,
              att.flash_attention_backward.launches)
    out = att.flash_attention(q, q, q, causal=True)
    out.sum().backward()
    torch.cuda.synchronize()
    assert (att.flash_attention.launches,
            att.flash_attention_backward.launches) == (before[0] + 1,
                                                       before[1] + 1)
    assert bool(torch.isfinite(q.grad).all())


def test_flash_backward_refuses_what_it_does_not_take(cuda):
    torch, att = cuda
    from mxtpu_torch.base import MXNetError
    q = torch.randn(1, 1, 8, 64, device="cuda")
    lse = torch.zeros(1, 1, 8, device="cuda")
    with pytest.raises(MXNetError, match="lse"):
        att.flash_attention_backward(q, q, q, q, q, lse.double())
    with pytest.raises(MXNetError, match="out"):
        att.flash_attention_backward(q, q, q, q.half(), q, lse)


def test_module_step_on_gpu_matches_cpu(cuda):
    """One fused SGD step of a small LM on gpu(0) and on cpu() from the
    same weights: outputs and updated weights within 1e-5."""
    torch, att = cuda
    import numpy as np
    import mxtpu_torch as mt
    cfg = dict(vocab_size=50, seq_len=64, num_layers=2, num_heads=2,
               d_model=64)
    rng = np.random.RandomState(0)
    x = rng.randint(0, 50, (2, 64)).astype(np.float32)
    y = rng.randint(0, 50, 128).astype(np.float32)
    got, weights = [], None
    for ctx in (mt.gpu(0), mt.cpu()):
        mod = mt.mod.Module(mt.models.get_transformer_lm(**cfg), context=ctx)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        if weights is None:
            np.random.seed(1)
            mod.init_params(mt.init.Xavier())
            weights = mod.get_params()[0]
        else:
            mod.init_params(arg_params=weights)
        mod.init_optimizer(optimizer="sgd",
                           optimizer_params={"learning_rate": 0.05})
        before = att.flash_attention_backward.launches
        mod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(x, ctx=mt.cpu())], [mt.nd.array(y, ctx=mt.cpu())]))
        mod.update()
        if ctx.device_type == "gpu":
            assert att.flash_attention_backward.launches == before + 2
        got.append((mod.get_outputs()[0].asnumpy(),
                    {k: v.asnumpy() for k, v in mod.get_params()[0].items()}))
    (go, gw), (co, cw) = got
    assert np.abs(go - co).max() <= 1e-5
    for k in cw:
        assert np.abs(gw[k] - cw[k]).max() <= 1e-5, k


@pytest.mark.parametrize("dtype,tol_out,tol_grad", [
    ("float32", 1e-5, 1e-4), ("bfloat16", 2.0 ** -7, 2.0 ** -6)])
@pytest.mark.parametrize("shape,axis,attrs", [
    ((4, 8, 16, 16), 1, {"fix_gamma": False}),
    ((4, 8, 16, 16), 1, {}),
    ((2, 7, 9, 24), 3, {"fix_gamma": False, "output_mean_var": True}),
    ((64, 33), 1, {"fix_gamma": False, "momentum": 0.5}),
    ((1, 4, 1, 1), 1, {"fix_gamma": False}),
    ((4, 8, 16, 16), 1, {"fix_gamma": False, "use_global_stats": True})])
def test_batchnorm_training_on_cuda_matches_cpu(cuda, dtype, tol_out,
                                                tol_grad, shape, axis, attrs):
    """The port's BatchNorm in training on gpu(0) and on the CPU from the
    same inputs: outputs and updated moving statistics within tol_out of
    the largest value, the gradients of data, gamma and beta within
    tol_grad of the largest (f32: sums in other orders; bf16: one and two
    bf16 steps)."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    rng = np.random.RandomState(len(shape) + axis)
    c = shape[axis]
    host = [rng.randn(*shape) * 2 + 0.5, rng.rand(c) + 0.5, rng.randn(c),
            rng.randn(c) * 0.3, rng.rand(c) + 0.5]
    head = rng.randn(*shape)
    dt = getattr(torch, dtype)
    got = {}
    for dev in ("cuda", "cpu"):
        leaves = [torch.tensor(v, dtype=dt, device=dev, requires_grad=True)
                  for v in host[:3]]
        stats = [torch.tensor(v, dtype=torch.float32, device=dev)
                 for v in host[3:]]
        op, a, outs = mt.ops.registry.invoke(
            "BatchNorm", leaves + stats,
            dict(attrs, axis=axis, __is_train__=True))
        grads = torch.autograd.grad(
            outs[0], leaves, torch.tensor(head, dtype=dt, device=dev),
            allow_unused=True)
        got[dev] = ([o.detach().float().cpu() for o in outs],
                    [torch.zeros(v.shape) if g is None else g.float().cpu()
                     for v, g in zip(host, grads)])

    def scaled(x, y):
        return float((x - y).abs().max() / max(float(y.abs().max()), 1e-30))

    for x, y in zip(got["cuda"][0], got["cpu"][0]):
        assert scaled(x, y) <= tol_out
    for x, y in zip(got["cuda"][1], got["cpu"][1]):
        if float(y.abs().max()):
            assert scaled(x, y) <= tol_grad
        else:
            assert not float(x.abs().max())


def test_device_prefetch_waits_for_a_delayed_side_stream(cuda):
    """DevicePrefetchIter onto gpu(0) with its side stream held back by a
    spin kernel before every copy: each consumed batch, read on the
    consumer's stream, equals its host source bit for bit (a missing wait
    would read the staged memory before the copy lands), the staged
    tensors sit on cuda:0, and the host buffers they came through are
    pinned."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt

    class Delayed(mt.io.DevicePrefetchIter):
        def _stage(self, batch):
            with torch.cuda.device(self.device), \
                    torch.cuda.stream(self._stream):
                torch.cuda._sleep(50_000_000)  # ~25 ms at ~2 GHz
            return super()._stage(batch)

    rng = np.random.RandomState(0)
    x = rng.rand(48, 3, 32, 32).astype(np.float32)
    y = rng.randint(0, 10, 48).astype(np.float32)
    it = Delayed(mt.io.NDArrayIter(x, y, batch_size=8), device=mt.gpu(0))
    try:
        for epoch in range(2):
            n = 0
            for batch in it:
                d, lbl = batch.data[0]._data, batch.label[0]._data
                assert d.device == torch.device("cuda", 0)
                assert torch.equal(d.cpu(), torch.from_numpy(
                    x[8 * n:8 * (n + 1)]))
                assert torch.equal(lbl.cpu(), torch.from_numpy(
                    y[8 * n:8 * (n + 1)]))
                n += 1
            assert n == 6
            it.reset()
        bufs = it.host_buffers
        assert bufs and all(b.is_pinned() for b in bufs)
    finally:
        it.close()


def test_module_fit_with_device_prefetch_on_gpu(cuda):
    """resnet-8 trained by fit on gpu(0) with and without
    ``device_prefetch``, from the same weights, with cuDNN's deterministic
    algorithms (for this test only): the same weights and statistics bit
    for bit."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    rng = np.random.RandomState(1)
    x = rng.rand(64, 3, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 64).astype(np.float32)
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark, torch.backends.cudnn.allow_tf32)
    torch.backends.cudnn.deterministic = True
    torch.backends.cudnn.benchmark = False
    torch.backends.cudnn.allow_tf32 = False
    out = []
    try:
        for prefetch in (False, True):
            np.random.seed(2)
            mod = mt.mod.Module(mt.models.get_resnet(10, 8, (3, 28, 28)),
                                context=mt.gpu(0))
            mod.fit(mt.io.NDArrayIter(x, y, batch_size=16), num_epoch=2,
                    initializer=mt.init.Xavier(), device_prefetch=prefetch,
                    optimizer_params={"learning_rate": 0.05})
            out.append([{k: v._data for k, v in d.items()}
                        for d in mod.get_params()])
    finally:
        (torch.backends.cudnn.deterministic, torch.backends.cudnn.benchmark,
         torch.backends.cudnn.allow_tf32) = flags
    for a, b in zip(*out):
        for k in a:
            assert bool(torch.isfinite(a[k]).all())
            assert torch.equal(a[k], b[k]), k


def _narrow_resnet_v2(mt):
    v = mt.gluon.model_zoo.vision
    return v.ResNetV2(v.BasicBlockV2, [1, 1, 1], [16, 16, 32, 64],
                      classes=10, thumbnail=True)


def _gluon_step(mt, ctx, values, x, y, hybridize):
    """One SGD step of the narrow ResNetV2 on ``ctx`` from ``values``
    (by stripped name): (loss, {name: value after the step})."""
    net = _narrow_resnet_v2(mt)
    mt.convert.gluon_params_from_mxtpu(values, ctx, block=net)
    if hybridize:
        net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                               {"learning_rate": 0.1})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    data, label = mt.nd.array(x, ctx=ctx), mt.nd.array(y, ctx=ctx)
    with mt.autograd.record():
        loss = loss_fn(net(data), label)
    loss.backward()
    trainer.step(x.shape[0])
    return loss.asnumpy(), {k[len(net.prefix):]: p.data().asnumpy()
                            for k, p in net.collect_params().items()}


@pytest.mark.parametrize("hybridize", [False, True],
                         ids=["imperative", "hybridized"])
def test_gluon_step_on_gpu_matches_cpu(cuda, hybridize):
    """One Gluon SGD step (autograd.record, backward, Trainer.step) of the
    narrow ResNetV2 on gpu(0) and on cpu() from the same weights: the
    losses and the updated weights and moving statistics within 1e-5 of
    the largest value (f32, TF32 off: sums in other orders)."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    torch.backends.cudnn.allow_tf32 = False
    rng = np.random.RandomState(3)
    x = rng.rand(16, 3, 28, 28).astype(np.float32)
    y = rng.randint(0, 10, 16).astype(np.float32)
    with mt.cpu():
        np.random.seed(4)
        net = _narrow_resnet_v2(mt)
        net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2))
        net(mt.nd.array(x[:1]))
        values = {k[len(net.prefix):]: p.data().asnumpy()
                  for k, p in net.collect_params().items()}
    gl, gw = _gluon_step(mt, mt.gpu(0), values, x, y, hybridize)
    with mt.cpu():
        cl, cw = _gluon_step(mt, mt.cpu(), values, x, y, hybridize)
    assert np.abs(gl - cl).max() <= 1e-5 * max(1.0, np.abs(cl).max())
    for k in cw:
        scale = max(1.0, float(np.abs(cw[k]).max()))
        assert np.abs(gw[k] - cw[k]).max() <= 1e-5 * scale, k


def test_gluon_hybridized_eval_forward_launches_the_epilogue(cuda):
    """The hybridized inference plan of the narrow ResNetV2 on gpu(0):
    one epilogue launch per fused BatchNorm->ReLU site (7), none in a
    training forward or a forward recorded in predict mode (whose
    gradients flow), and the output within 1e-5 of the same forward
    through the epilogue's plain version."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    from mxtpu_torch.ops import epilogue as epi
    from mxtpu_torch.ops import nn as nn_ops
    rng = np.random.RandomState(5)
    x = mt.nd.array(rng.rand(8, 3, 28, 28).astype(np.float32), ctx=mt.gpu(0))
    np.random.seed(6)
    net = _narrow_resnet_v2(mt)
    net.initialize(mt.init.Xavier(), ctx=mt.gpu(0))
    net.hybridize()
    with mt.autograd.record():  # moves the statistics; fuses nothing
        before = epi.bn_apply_relu_add.launches
        net(x)
        assert epi.bn_apply_relu_add.launches == before
    # recorded in predict mode: the inference plan, unfused, so the
    # gradient reaches the first convolution (the kernel has none)
    with mt.autograd.record(train_mode=False):
        loss = net(x).sum()
    loss.backward()
    assert epi.bn_apply_relu_add.launches == before
    w = net.collect_params()[net.prefix + "conv2d0_weight"]
    assert float(w.grad()._data.abs().sum()) > 0
    before = epi.bn_apply_relu_add.launches
    got = net(x)._data.clone()
    assert net.fused_sites == 7
    assert epi.bn_apply_relu_add.launches == before + 7
    kernel = nn_ops.bn_apply_relu_add
    nn_ops.bn_apply_relu_add = lambda x, scale, shift, residual=None, \
        axis=-1, **_: epi.bn_apply_relu_add_reference(x, scale, shift,
                                                      residual, axis)
    try:
        want = net(x)._data
    finally:
        nn_ops.bn_apply_relu_add = kernel
    assert float((got - want).abs().max()) <= 1e-5 * max(
        1.0, float(want.abs().max()))


def test_nd_ops_on_the_card_stay_on_the_card(cuda):
    """Every imperative path keeps a CUDA array on its card: the nd
    functions, the operators, indexing, creation with ctx=gpu(0), the
    gradient buffers, a DataLoader batch by default (gpu(0)), and the
    Trainer's state."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    dev = torch.device("cuda", 0)
    a = mt.nd.array(np.random.RandomState(0).randn(4, 5), ctx=mt.gpu(0))
    idx = mt.nd.array([0, 2, 1, 4], ctx=mt.gpu(0))
    a.attach_grad()
    with mt.autograd.record():
        outs = [mt.nd.relu(a), mt.nd.exp(a), a * 2, 2 - a, a / (a * a + 1),
                a > 0, mt.nd.sum(a, axis=1), a.mean(), mt.nd.pick(a, idx),
                mt.nd.take(a, idx), mt.nd.log_softmax(a), a[1:3], a[::-1],
                a.T, mt.nd.stack(a, a), mt.nd.maximum(a, 0.5),
                mt.nd.where(a > 0, a, a * 0.1), a.reshape((5, 4))]
        total = sum(o.sum() for o in outs if o.dtype == np.float32)
    total.backward()
    for o in outs + [total, a.grad, mt.nd.zeros((2,), ctx=mt.gpu(0)),
                     mt.nd.ones((2,), ctx=mt.gpu(0)),
                     mt.nd.arange(4, ctx=mt.gpu(0))]:
        assert o._data.device == dev and o.context == mt.gpu(0)
    ds = mt.gluon.data.ArrayDataset(np.ones((4, 3), np.float32),
                                    np.arange(4, dtype=np.float32))
    for nw in (0, 2):
        for d, lbl in mt.gluon.data.DataLoader(ds, batch_size=2,
                                               num_workers=nw):
            assert d._data.device == dev and lbl._data.device == dev
    net = mt.gluon.nn.Dense(3)
    net.initialize()  # gpu(0) by default
    tr = mt.gluon.Trainer(net.collect_params(), "sgd",
                          {"learning_rate": 0.1, "momentum": 0.9})
    with mt.autograd.record():
        loss = net(mt.nd.ones((2, 5), ctx=mt.gpu(0))).sum()
    loss.backward()
    tr.step(2)
    for p in net.collect_params().values():
        assert p.data()._data.device == dev and p.grad()._data.device == dev
    assert all(s._data.device == dev
               for s in tr._updaters[0].states.values())


# ---------------------------------------------------------------- several
def _gpus(torch, n):
    if torch.cuda.device_count() < n:
        pytest.skip("needs %d CUDA devices" % n)
    return n


def test_kvstore_on_cuda_values(cuda):
    """KVStore local and device on CUDA values: a pushed list summed bit
    for bit as the host adds it in list order, the updater run on the
    store, and set_optimizer's SGD with momentum bit for bit the same
    arithmetic on the host."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    rng = np.random.RandomState(0)
    vals = [rng.randn(64, 33).astype(np.float32) for _ in range(4)]
    for kind in ("local", "device"):
        kv = mt.kv.create(kind)
        kv.init("w", mt.nd.zeros((64, 33), ctx=mt.gpu(0)))
        kv.push("w", [mt.nd.array(v, ctx=mt.gpu(0)) for v in vals])
        out = mt.nd.zeros((64, 33), ctx=mt.gpu(0))
        kv.pull("w", out=out)
        want = torch.from_numpy(vals[0])
        for v in vals[1:]:
            want = want + torch.from_numpy(v)
        assert torch.equal(out._data.cpu(), want)
        kv = mt.kv.create(kind)
        kv.set_optimizer(mt.optimizer.SGD(learning_rate=0.1, momentum=0.9,
                                          rescale_grad=0.5))
        w = rng.randn(64, 33).astype(np.float32)
        kv.init(0, mt.nd.array(w, ctx=mt.gpu(0)))
        mom = np.zeros_like(w)
        for v in vals[:2]:
            kv.push(0, mt.nd.array(v, ctx=mt.gpu(0)))
            mom = (0.9 * mom - np.float32(0.1) * (np.float32(0.5) * v)) \
                .astype(np.float32)
            w = (w + mom).astype(np.float32)
        kv.pull(0, out=out)
        np.testing.assert_allclose(out.asnumpy(), w, rtol=0, atol=1e-6)


def test_kvstore_over_several_gpus(cuda):
    """A list pushed from each card is summed on the first, in list
    order, and pulled into every card's array in place."""
    torch, _ = cuda
    n = _gpus(torch, 2)
    import numpy as np
    import mxtpu_torch as mt
    rng = np.random.RandomState(1)
    vals = [rng.randn(1000).astype(np.float32) for _ in range(n)]
    kv = mt.kv.create("device")
    kv.init(3, mt.nd.zeros((1000,), ctx=mt.gpu(0)))
    kv.push(3, [mt.nd.array(v, ctx=mt.gpu(i)) for i, v in enumerate(vals)])
    outs = [mt.nd.zeros((1000,), ctx=mt.gpu(i)) for i in range(n)]
    kv.pull(3, out=outs)
    want = torch.from_numpy(vals[0])
    for v in vals[1:]:
        want = want + torch.from_numpy(v)
    for i, o in enumerate(outs):
        assert o._data.device == torch.device("cuda", i)
        assert torch.equal(o._data.cpu(), want)


def test_kernels_on_every_card(cuda):
    """Each kernel on each card against its plain version on that card:
    flash forward and backward (f32) and the epilogue (bit for bit)."""
    torch, att = cuda
    n = _gpus(torch, 2)
    from mxtpu_torch.ops import epilogue as epi
    for i in range(n):
        dev = torch.device("cuda", i)
        g = torch.Generator(device=dev).manual_seed(i)
        q, k, v, do = (torch.randn(2, 2, 130, 64, device=dev, generator=g)
                       for _ in range(4))
        out, lse = att._flash_forward(q, k, v, True, att._scale(64, None),
                                      want_lse=True)
        ref, ref_lse = att.flash_attention_reference(q, k, v, causal=True,
                                                     return_lse=True)
        assert out.device == dev and lse.device == dev
        assert float((out - ref).abs().max()) <= 2e-4
        assert float((lse - ref_lse).abs().max()) <= 1e-4
        dq, dk, dv = att.flash_attention_backward(q, k, v, out, do, lse,
                                                  causal=True)
        want = att.flash_attention_backward_reference(q, k, v, out, do, lse,
                                                      causal=True)
        for got, w in zip((dq, dk, dv), want):
            assert got.device == dev
            assert float(((got - w).abs() / w.abs().clamp(min=1)).max()) \
                <= 1e-4
        x = torch.randn(4, 16, 9, 9, device=dev, generator=g)
        s, b = (torch.randn(16, device=dev, generator=g) for _ in range(2))
        y = epi.bn_apply_relu_add(x, s, b, axis=1)
        assert y.device == dev
        assert torch.equal(y, epi.bn_apply_relu_add_reference(x, s, b, None,
                                                              1))


def test_module_over_two_gpus_is_the_whole_batch_step(cuda):
    """A BatchNorm net through Module.fit over [gpu(0), gpu(1)] (the
    fused step: BatchNorm over the whole batch, one NCCL sum a step)
    equals gpu(0) alone on the whole batch within 1e-5, and its replicas
    are bit-identical."""
    torch, _ = cuda
    _gpus(torch, 2)
    import numpy as np
    import mxtpu_torch as mt
    rng = np.random.RandomState(0)
    x = (rng.randn(32, 3, 8, 8) * 3).astype(np.float32)
    x[16:] += 5.0
    y = rng.randint(0, 4, 32).astype(np.float32)
    s = mt.sym
    h = s.Convolution(s.Variable("data"), kernel=(3, 3), num_filter=8,
                      name="c")
    h = s.Activation(s.BatchNorm(h, name="bn", fix_gamma=False),
                     act_type="relu")
    h = s.FullyConnected(h, num_hidden=4, name="fc")
    net = s.SoftmaxOutput(h, name="softmax")
    res = []
    for ctxs in ([mt.gpu(0)], [mt.gpu(0), mt.gpu(1)]):
        np.random.seed(3)
        mod = mt.mod.Module(net, context=ctxs)
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=32), num_epoch=3,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mt.init.Xavier(), kvstore="device")
        assert mod._fused is not None
        res.append([{k: v.asnumpy() for k, v in d.items()}
                    for d in mod.get_params()])
    for a, b in zip(*res):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    e0, e1 = mod._exec_group.execs
    for k, v in e0.arg_dict.items():
        if k in mod._param_names:
            assert torch.equal(v._data.cpu(), e1.arg_dict[k]._data.cpu()), k
    for k, v in e0.aux_dict.items():
        assert torch.equal(v._data.cpu(), e1.aux_dict[k]._data.cpu()), k


def test_mesh_collectives_on_cards(cuda):
    """reduce_scatter / all_gather (NCCL) and ppermute / all_to_all (peer
    copies) over the cards against the host's arithmetic."""
    torch, _ = cuda
    n = min(_gpus(torch, 2), 4)
    from mxtpu_torch.ops import collective as C
    g = torch.Generator().manual_seed(0)
    host = [torch.randn(n * 1000, generator=g) for _ in range(n)]
    ins = [h.to("cuda:%d" % i) for i, h in enumerate(host)]
    outs = [torch.empty(1000, device="cuda:%d" % i) for i in range(n)]
    C.reduce_scatter_replicas(ins, outs)
    total = sum(host)
    for r, o in enumerate(outs):
        assert o.device == torch.device("cuda", r)
        torch.testing.assert_close(o.cpu(), total[r * 1000:(r + 1) * 1000],
                                   rtol=1e-6, atol=1e-6)
    gathered = [torch.empty(n * 1000, device="cuda:%d" % i)
                for i in range(n)]
    C.all_gather_replicas(outs, gathered)
    for gt in gathered:
        assert torch.equal(gt.cpu(), torch.cat([o.cpu() for o in outs]))
    perm = [(i, (i + 1) % n) for i in range(n)]
    moved = C.ppermute(ins, perm)
    for i, j in perm:
        assert moved[j].device == ins[j].device
        assert torch.equal(moved[j].cpu(), host[i])
    vals = [h.view(n, 1000) for h in ins]
    a2a = C.all_to_all(vals, 0, 1)
    for j, o in enumerate(a2a):
        assert o.device == ins[j].device
        assert torch.equal(o.cpu(), torch.cat(
            [h.view(n, 1000)[j:j + 1] for h in host], dim=1))


@pytest.mark.parametrize("dim", [0, 1])
def test_group_collectives_on_cards_equal_the_host(cuda, dim):
    """all_reduce_groups / all_gather_groups / reduce_scatter_groups
    (in-process NCCL within each group of a data:2,tp:2 layout of four
    cards, along ``dim``) against the same calls on cpu(0..3) (the host's
    sums in group order): sums within 1e-6, gathers bit for bit."""
    torch, _ = cuda
    _gpus(torch, 4)
    import mxtpu_torch as mt
    from mxtpu_torch.ops import collective as C
    from mxtpu_torch.parallel.mesh import Mesh, ReplicaLayout
    g = torch.Generator().manual_seed(dim)
    host = [torch.randn(8, 12, generator=g) for _ in range(4)]
    for axes in (("tp",), ("data",), ("data", "tp")):
        res = []
        for ctx in (mt.gpu, mt.cpu):
            lay = ReplicaLayout(Mesh([ctx(i) for i in range(4)],
                                     ("data", "tp"), (2, 2)))
            groups = lay.groups(axes)
            xs = [h.to(ctx(i).torch_device) for i, h in enumerate(host)]
            summed = [x.clone() for x in xs]
            C.all_reduce_groups(summed, groups)
            gathered = C.all_gather_groups(xs, groups, dim)
            scattered = C.reduce_scatter_groups(xs, groups, dim)
            for out in (summed, gathered, scattered):
                assert [t.device for t in out] == [x.device for x in xs]
            res.append([[t.cpu() for t in out]
                        for out in (summed, gathered, scattered)])
        (sg, gg, rg), (sc, gc, rc) = res
        for a, b in zip(sg + rg, sc + rc):
            torch.testing.assert_close(a, b, rtol=1e-6, atol=1e-6)
        for a, b in zip(gg, gc):
            assert torch.equal(a, b)


@pytest.mark.parametrize("spec", ["data:2,tp:2", "data:2,fsdp:2"])
def test_fit_on_a_2d_mesh_of_cards_matches_the_cpu(cuda, spec):
    """The mlp through Module(gpu(0)).fit(mesh=spec) over gpu(0..3)
    (NCCL within the tp / fsdp / data groups) against the same fit over
    cpu(0..3), from the same weights: weights within 1e-5, each card
    holding its blocks."""
    torch, _ = cuda
    _gpus(torch, 4)
    import numpy as np
    import mxtpu_torch as mt
    rng = np.random.RandomState(1)
    x = rng.rand(128, 784).astype(np.float32)
    y = rng.randint(0, 10, 128).astype(np.float32)
    sym = mt.models.mlp.get_symbol(10)
    shapes = dict(zip(sym.list_arguments(),
                      sym.infer_shape(data=(64, 784))[0]))
    w0 = {k: (rng.rand(*s_).astype(np.float32) - 0.5) * 0.2
          for k, s_ in shapes.items() if k not in ("data", "softmax_label")}
    res = []
    for ctx in (mt.gpu, mt.cpu):
        mesh = mt.sharding.MeshContext.create(
            spec, devices=[ctx(i) for i in range(4)])
        mod = mt.mod.Module(sym, context=ctx(0))
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=64), num_epoch=2,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                            for k, v in w0.items()}, mesh=mesh)
        res.append({k: v.asnumpy() for k, v in mod.get_params()[0].items()})
        lay = mod._fused._plan.replica_layout()
        assert lay.specs
        for r, e in enumerate(mod._exec_group.execs):
            assert e.arg_dict["fc1_weight"]._data.device == \
                ctx(r).torch_device
            assert tuple(e.arg_dict["fc1_weight"].shape) == \
                lay.local_shape("fc1_weight", (128, 784))
    for k in res[1]:
        np.testing.assert_allclose(res[0][k], res[1][k], rtol=1e-5,
                                   atol=1e-5, err_msg=k)


def test_dist_async_two_processes_on_one_card(cuda, tmp_path):
    """dist_async from env:// with two processes on gpu(0): rank 0 hosts
    the async server; rank 1's pull sees its own push while rank 0 waits;
    pushes of CUDA values land on the server and pull back onto the
    card."""
    torch, _ = cuda
    import os
    import socket
    import subprocess
    import sys
    import textwrap
    src = textwrap.dedent("""
        import numpy as np
        import mxtpu_torch as mt
        kv = mt.kv.create("dist_async")
        ctx = mt.gpu(0)
        kv.init(0, mt.nd.zeros((3,), ctx=ctx))
        if kv.rank == 1:
            for i in range(3):
                kv.push(0, mt.nd.ones((3,), ctx=ctx) * (i + 1))
                out = mt.nd.zeros((3,), ctx=ctx)
                kv.pull(0, out=out)
                assert out._data.device.type == "cuda"
                assert out.asnumpy()[0] == i + 1, out.asnumpy()
        kv.barrier()
        out = mt.nd.zeros((3,), ctx=ctx)
        kv.pull(0, out=out)
        assert out.asnumpy()[0] == 3.0
        kv.close()
        print("WORKER_OK")
    """)
    with socket.socket() as s_:
        s_.bind(("127.0.0.1", 0))
        port = s_.getsockname()[1]
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, PYTHONPATH=root, WORLD_SIZE="2",
               MASTER_ADDR="127.0.0.1", MASTER_PORT=str(port))
    procs = [subprocess.Popen([sys.executable, "-c", src],
                              env=dict(env, RANK=str(r)),
                              stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT) for r in range(2)]
    try:
        outs = [p.communicate(timeout=180)[0].decode() for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    for p, o in zip(procs, outs):
        assert p.returncode == 0 and "WORKER_OK" in o, o


@pytest.mark.parametrize("dtype,fwd_tol,grad_tol", [
    ("float32", 2e-4, 1e-4), ("bfloat16", 2e-2, 2e-2)])
@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("fn", ["ring_attention", "ulysses_attention"])
def test_sequence_parallel_on_four_cards_matches_the_plain_hops(
        cuda, fn, causal, dtype, fwd_tol, grad_tol):
    """Ring / Ulysses attention over gpu(0..3) (each hop a flash forward
    and backward kernel launch on its card) against the same function
    over cpu(0..3) (each hop the plain version), forward and gradients:
    the kernels' gates (forward f32 2e-4, bf16 2e-2; gradients 1e-4 and
    2e-2 of max(1, |plain|))."""
    torch, att = cuda
    _gpus(torch, 4)
    import mxtpu_torch as mt
    dt = getattr(torch, dtype)
    g = torch.Generator().manual_seed(3)
    q, k, v, do = (torch.randn(2, 256, 4, 64, generator=g).to(dt)
                   for _ in range(4))
    runs = []
    for ctx in (mt.gpu, mt.cpu):
        mesh = mt.parallel.make_mesh((4,), ("seq",),
                                     devices=[ctx(i) for i in range(4)])
        dev = ctx(0).torch_device
        xs = [a.to(dev).requires_grad_(True) for a in (q, k, v)]
        before = (att.flash_attention.launches,
                  att.flash_attention_backward.launches)
        out = getattr(mt.parallel, fn)(*xs, mesh=mesh, causal=causal)
        grads = torch.autograd.grad(out, xs, do.to(dev))
        launched = (att.flash_attention.launches - before[0],
                    att.flash_attention_backward.launches - before[1])
        runs.append((out.float().cpu(), [x.float().cpu() for x in grads],
                     launched))
    (out, grads, launched), (pout, pgrads, plain) = runs
    hops = (10 if causal else 16) if fn == "ring_attention" else 4
    assert launched == (hops, hops) and plain == (0, 0)
    assert float((out - pout).abs().max()) <= fwd_tol
    for a, b in zip(grads, pgrads):
        scale = max(1.0, float(b.abs().max()))
        assert float((a - b).abs().max()) / scale <= grad_tol


def test_fit_mesh_on_cards_is_the_replicated_step(cuda):
    """A BatchNorm net through Module(gpu(0)).fit(mesh=n): the sharded
    fused step over the mesh's cards (fc_weight's rows by replica)
    within 1e-5 of the replicated fused path over the same cards, its
    replicas bit-identical."""
    torch, _ = cuda
    n = min(_gpus(torch, 2), 4)
    import numpy as np
    import mxtpu_torch as mt
    rng = np.random.RandomState(0)
    x = (rng.randn(32, 3, 8, 8) * 3).astype(np.float32)
    y = rng.randint(0, 4, 32).astype(np.float32)
    s = mt.sym
    h = s.Convolution(s.Variable("data"), kernel=(3, 3), num_filter=64,
                      name="c")
    h = s.Activation(s.BatchNorm(h, name="bn", fix_gamma=False),
                     act_type="relu")
    h = s.FullyConnected(h, num_hidden=4, name="fc")
    net = s.SoftmaxOutput(h, name="softmax")
    res = []
    for ctxs, mesh in (([mt.gpu(i) for i in range(n)], False),
                       ([mt.gpu(0)], n)):
        np.random.seed(3)
        mod = mt.mod.Module(net, context=ctxs)
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=32), num_epoch=3,
                optimizer_params={"learning_rate": 0.1, "momentum": 0.9},
                initializer=mt.init.Xavier(), kvstore="device", mesh=mesh)
        res.append([{k: v.asnumpy() for k, v in d.items()}
                    for d in mod.get_params()])
    assert mod._fused._plan is not None
    assert mod._fused.sharded_names == ["fc_weight"]
    for a, b in zip(*res):
        for k in a:
            np.testing.assert_allclose(b[k], a[k], rtol=1e-5, atol=1e-5,
                                       err_msg=k)
    execs = mod._exec_group.execs
    assert len(execs) == n
    for e in execs[1:]:
        for k in mod._param_names:
            assert torch.equal(e.arg_dict[k]._data.cpu(),
                               execs[0].arg_dict[k]._data.cpu()), k


# ---------------------------------------------------------------- RNN
def _rnn_case(torch, mode, bi, layers, t, n, state_batch, seed=0):
    """(attrs, [data, parameters, state(, state_cell)]) on cuda:0, f32."""
    import numpy as np
    from mxtpu_torch.ops import rnn
    i, h = 7, 5
    d = 2 if bi else 1
    rng = np.random.RandomState(seed)
    size = rnn.rnn_param_size(layers, i, h, mode, bi)
    arrays = [rng.randn(t, n, i), rng.randn(size) * 0.4,
              rng.randn(layers * d, state_batch, h) * 0.5]
    if mode == "lstm":
        arrays.append(rng.randn(layers * d, state_batch, h) * 0.5)
    attrs = {"state_size": h, "num_layers": layers, "mode": mode,
             "bidirectional": bi, "state_outputs": True}
    return attrs, [torch.tensor(a, dtype=torch.float32, device="cuda")
                   for a in arrays]


@pytest.mark.parametrize("mode", ["rnn_relu", "rnn_tanh", "lstm", "gru"])
@pytest.mark.parametrize("bi,layers,t,n,state_batch", [
    (False, 1, 1, 1, 1), (False, 2, 9, 4, 4), (True, 2, 9, 4, 1),
    (True, 1, 3, 5, 5)])
def test_rnn_cudnn_route_matches_the_loop_on_the_card(cuda, mode, bi, layers,
                                                      t, n, state_batch):
    """The RNN op on a CUDA tensor takes cuDNN's RNN (the route count
    moves); its outputs and the gradients of data, parameters and both
    states are within 1e-4 of max(1, the largest) of the plain loop's on
    the same card (f32, TF32 off in cuBLAS and cuDNN; cuDNN's tanh and
    sigmoid differ from torch's by an ulp or two, which the steps
    compound: up to 2.9e-5 on an H100)."""
    torch, _ = cuda
    torch.backends.cudnn.allow_tf32 = False
    from mxtpu_torch.ops import registry, rnn
    attrs, xs = _rnn_case(torch, mode, bi, layers, t, n, state_batch)
    op = registry.get_op("RNN")
    a = op.parse_attrs(attrs)
    d = 2 if bi else 1
    res = []
    for route in ("cudnn", "loop"):
        leaves = [x.clone().requires_grad_() for x in xs]
        before = dict(rnn.ROUTES)
        if route == "cudnn":
            outs = op.apply(a, leaves)
            assert rnn.ROUTES["cudnn"] == before["cudnn"] + 1
        else:
            full = (layers * d, n, 5)
            cell = leaves[3].expand(full) if mode == "lstm" else None
            outs = [o for o in rnn._loop_rnn(
                a, None, leaves[0], rnn._unpack(leaves[1], layers, 7, 5,
                                                mode, d),
                leaves[2].expand(full), cell, None) if o is not None]
        heads = [torch.ones_like(o) * 0.1 + o.detach() for o in outs]
        grads = torch.autograd.grad(outs, leaves, heads)
        res.append([o.detach() for o in outs] + list(grads))
    for got, want in zip(*res):
        scale = max(1.0, float(want.abs().max()))
        assert float((got - want).abs().max()) <= 1e-4 * scale


def test_rnn_clip_takes_the_loop_on_the_card(cuda):
    """With the LSTM state clip set, the op runs the loop on the card (the
    declared route): the cuDNN count stays, the result is the loop's."""
    torch, _ = cuda
    from mxtpu_torch.ops import registry, rnn
    attrs, xs = _rnn_case(torch, "lstm", True, 2, 6, 3, 3, seed=1)
    attrs.update(lstm_state_clip_min=-0.2, lstm_state_clip_max=0.2)
    op = registry.get_op("RNN")
    before = dict(rnn.ROUTES)
    outs = op.apply(op.parse_attrs(attrs), xs)
    assert rnn.ROUTES["cudnn"] == before["cudnn"]
    assert rnn.ROUTES["loop"] == before["loop"] + 1
    assert outs[0].device.type == "cuda"
    assert float(outs[2].abs().max()) <= 0.2 + 1e-7


def test_rnn_refuses_what_cudnn_does_not_take(cuda):
    """A CUDA tensor cuDNN does not accept raises (no quiet loop)."""
    torch, _ = cuda
    import mxtpu_torch as mt
    from mxtpu_torch.ops import registry
    attrs, xs = _rnn_case(torch, "gru", False, 1, 3, 2, 2)
    op = registry.get_op("RNN")
    flag = torch.backends.cudnn.enabled
    torch.backends.cudnn.enabled = False
    try:
        with pytest.raises(mt.MXNetError, match="cuDNN"):
            op.apply(op.parse_attrs(attrs), xs)
    finally:
        torch.backends.cudnn.enabled = flag


@pytest.mark.parametrize("fused", [False, True])
def test_bucketing_step_on_the_card_matches_cpu(cuda, fused):
    """One BucketingModule step of a narrow LSTM LM per bucket on gpu(0)
    against the same steps on cpu(), from the same weights: weights
    within 1e-5 and outputs within 1e-4 relative; every bucket shares
    the default bucket's tensors on the card."""
    torch, _ = cuda
    torch.backends.cudnn.allow_tf32 = False
    import numpy as np
    import mxtpu_torch as mt

    def sym_gen(seq_len):
        data = mt.sym.Variable("data")
        label = mt.sym.Variable("softmax_label")
        x = mt.sym.Embedding(data, input_dim=30, output_dim=8, name="embed")
        if fused:
            stack = mt.rnn.FusedRNNCell(12, num_layers=2, prefix="lstm_")
        else:
            stack = mt.rnn.SequentialRNNCell()
            for i in range(2):
                stack.add(mt.rnn.LSTMCell(12, prefix="lstm_l%d_" % i))
        out, _ = stack.unroll(seq_len, inputs=x, merge_outputs=True)
        out = mt.sym.FullyConnected(mt.sym.Reshape(out, shape=(-1, 12)),
                                    num_hidden=30, name="pred")
        return (mt.sym.SoftmaxOutput(out, mt.sym.Reshape(
            label, shape=(-1,)), name="softmax"), ("data",),
            ("softmax_label",))

    rng = np.random.RandomState(0)
    batches = []
    for key in (9, 5, 9):
        ids = rng.randint(1, 30, (4, key + 1)).astype(np.float32)
        batches.append(mt.io.DataBatch(
            [mt.nd.array(ids[:, :-1], ctx=mt.cpu())],
            [mt.nd.array(ids[:, 1:], ctx=mt.cpu())], bucket_key=key,
            provide_data=[mt.io.DataDesc("data", (4, key))],
            provide_label=[mt.io.DataDesc("softmax_label", (4, key))]))
    res = []
    w0 = None
    for ctx in (mt.gpu(0), mt.cpu()):
        mod = mt.mod.BucketingModule(sym_gen, default_bucket_key=9,
                                     context=ctx)
        mod.bind(batches[0].provide_data, batches[0].provide_label)
        if w0 is None:
            np.random.seed(1)
            mod.init_params(mt.init.Xavier())
            w0 = mod.get_params()[0]
        else:
            mod.init_params(arg_params=w0)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.1, "momentum": 0.9})
        outs = []
        for b in batches:
            mod.forward_backward(b)
            mod.update()
            outs.append(mod.get_outputs()[0].asnumpy())
        res.append((outs, {k: v.asnumpy()
                           for k, v in mod.get_params()[0].items()}))
        if ctx == mt.gpu(0):
            e5, e9 = (mod.buckets[k]._exec_group.execs[0] for k in (5, 9))
            for k in mod.buckets[9]._param_names:
                assert e5.arg_dict[k]._data.data_ptr() == \
                    e9.arg_dict[k]._data.data_ptr()
                assert e5.arg_dict[k]._data.device.type == "cuda"
    for g, c in zip(res[0][0], res[1][0]):
        np.testing.assert_allclose(g, c, rtol=1e-4, atol=1e-6)
    for k, c in res[1][1].items():
        np.testing.assert_allclose(res[0][1][k], c, rtol=0, atol=1e-5,
                                   err_msg=k)


def test_group2ctx_over_two_cards(cuda):
    """tests/test_parallel.py:153's net with its groups on gpu(0) and
    gpu(1): each group's outputs on its card, the inputs crossing once,
    outputs and gradients equal to the same net on gpu(0) alone."""
    torch, _ = cuda
    _gpus(torch, 2)
    import numpy as np
    import mxtpu_torch as mx
    with mx.AttrScope(ctx_group="dev1"):
        data = mx.sym.Variable("data")
        act1 = mx.sym.Activation(mx.sym.FullyConnected(
            data, num_hidden=8, name="fc1"), act_type="relu")
    with mx.AttrScope(ctx_group="dev2"):
        net = mx.sym.Activation(mx.sym.FullyConnected(
            act1, num_hidden=4, name="fc2"), act_type="tanh")
    g2c = {"dev1": mx.gpu(0), "dev2": mx.gpu(1)}
    split = net.simple_bind(mx.gpu(0), data=(2, 6), group2ctx=g2c)
    single = net.simple_bind(mx.gpu(0), data=(2, 6))
    assert split.arg_dict["fc2_weight"].context == mx.gpu(1)
    rng = np.random.RandomState(0)
    for name, arr in split.arg_dict.items():
        v = rng.rand(*arr.shape).astype(np.float32) - 0.5
        arr[:] = v
        single.arg_dict[name][:] = v
    res = []
    for exe in (split, single):
        out = exe.forward(is_train=True)[0]
        exe.backward([mx.nd.ones(out.shape, ctx=out.context)])
        res.append((out.asnumpy(), {k: g.asnumpy()
                                    for k, g in exe.grad_dict.items()}))
    assert split.outputs[0].context == mx.gpu(1)
    assert split.cross_device_copies == 1  # act1 into fc2
    np.testing.assert_allclose(res[0][0], res[1][0], rtol=1e-6, atol=1e-7)
    for k in res[1][1]:
        np.testing.assert_allclose(res[0][1][k], res[1][1][k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_embedding_out_of_range_ids_leave_the_context_usable(cuda):
    """Ids outside [-input_dim, input_dim) give NaN rows on the card, as
    on the host, and never reach the gather: the CUDA context still
    runs kernels afterwards."""
    torch, _ = cuda
    import mxtpu_torch as mt
    w = torch.arange(10.0, device="cuda").reshape(5, 2)
    ids = torch.tensor([-7, -6, -5, -1, 0, 4, 5, 9, 2.7, -0.5],
                       device="cuda")
    _, _, (y,) = mt.ops.registry.invoke(
        "Embedding", [ids, w], {"input_dim": 5, "output_dim": 2})
    torch.cuda.synchronize()
    want = [float("nan"), float("nan"), 0, 8, 0, 8, float("nan"),
            float("nan"), 4, 0]
    got = y[:, 0].cpu().tolist()
    assert [g != g for g in got] == [v != v for v in want]
    assert [g for g in got if g == g] == [v for v in want if v == v]
    z = torch.ones(1000, device="cuda") * 2  # the context still works
    torch.cuda.synchronize()
    assert float(z.sum()) == 2000.0


def _nms_set_ids():
    return ["random", "one_class_overlapping", "at_threshold", "inf_tails",
            "force_suppress", "nan_boxes", "k37", "k1376", "k1",
            "dead_between_live"]


@pytest.mark.parametrize("name", _nms_set_ids())
def test_nms_kernel_equals_plain_version(cuda, name):
    torch, _ = cuda
    from mxtpu_torch.models import ssd_data
    from mxtpu_torch.ops import contrib
    sets = {s[0]: s[1:] for s in ssd_data.nms_sets(batch=8)}
    boxes, scores, cls, thresh, force = sets[name]
    args = [torch.from_numpy(a).cuda() for a in (boxes, scores, cls)]
    before = contrib.nms_keep.launches
    got = contrib.nms_keep(*args, thresh, force)
    want = contrib.nms_keep_reference(*args, thresh, force)
    torch.cuda.synchronize()
    assert contrib.nms_keep.launches == before + 1
    assert got.dtype == torch.bool and got.shape == want.shape
    assert torch.equal(got, want)
    cpu = contrib.nms_keep(*[a.cpu() for a in args], thresh, force)
    assert torch.equal(got.cpu(), cpu)


def test_nms_kernel_refuses_what_it_does_not_take(cuda):
    torch, _ = cuda
    import mxtpu_torch as mt
    from mxtpu_torch.ops import contrib
    b = torch.rand(2, 5, 4, device="cuda")
    s = torch.rand(2, 5, device="cuda")
    with pytest.raises(mt.MXNetError, match="float32"):
        contrib.nms_keep(b.double(), s, s, 0.5)
    with pytest.raises(mt.MXNetError, match="contiguous"):
        contrib.nms_keep(b, s.t().contiguous().t(), s, 0.5)
    with pytest.raises(mt.MXNetError, match="CUDA"):
        contrib.nms_keep(b, s.cpu(), s, 0.5)


@pytest.mark.parametrize("b,k,live", [(4, 1757, None), (4, 2048, None),
                                      (4, 7486, None), (4, 7486, 50),
                                      (1, 24564, None)])
def test_nms_kernel_at_any_candidate_count(cuda, b, k, live):
    """Past the first kernel's 1,756: K = 2,048, SSD300's 7,486 anchors
    (all live, as at nms_topk=-1 on an untrained net, and 50 live, as on a
    trained one) and SSD512's 24,564, bit for bit against the plain
    version, one counted launch a call."""
    torch, _ = cuda
    import numpy as np
    from mxtpu_torch.ops import contrib
    rng = np.random.RandomState(k + (live or 0))
    c = rng.uniform(0.1, 0.9, (b, k, 2))
    half = rng.uniform(0.02, 0.45, (b, k, 2)) / 2
    boxes = np.concatenate([c - half, c + half], -1).astype(np.float32)
    scores = -np.sort(-rng.rand(b, k), axis=1).astype(np.float32)
    if live is not None:
        scores[:, live:] = -np.inf
    cls = rng.randint(0, 20, (b, k)).astype(np.float32)
    args = [torch.from_numpy(a).cuda() for a in (boxes, scores, cls)]
    before = contrib.nms_keep.launches
    got = contrib.nms_keep(*args, 0.45)
    torch.cuda.synchronize()
    assert contrib.nms_keep.launches == before + 1
    for i in range(b):  # the plain version's K x K temporaries an image
        want = contrib.nms_keep_reference(*(a[i:i + 1] for a in args), 0.45,
                                          False)
        assert torch.equal(got[i:i + 1], want), i
        assert 0 < int(want.sum()) <= (live or k)


def test_ssd_step_on_gpu_matches_cpu(cuda):
    """One fused SGD step of the tiny SSD on gpu(0) and on cpu() from the
    same weights: the targets equal, the suppression kernel launched once
    on the card, the class probabilities, the location loss and the
    updated weights within 1e-5 (cuDNN in f32, TF32 off)."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    from mxtpu_torch.models import ssd_data
    from mxtpu_torch.ops import contrib
    torch.backends.cudnn.allow_tf32 = False
    cfg = dict(num_classes=3, num_scales=3, network="tiny")
    x, lab = ssd_data.make_batch(np.random.RandomState(0), 4, (3, 64, 64), 3)
    got, weights = [], None
    for ctx in (mt.gpu(0), mt.cpu()):
        mod = mt.mod.Module(mt.models.ssd.get_symbol_train(**cfg),
                            label_names=("label",), context=ctx)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("label", lab.shape)])
        if weights is None:
            np.random.seed(1)
            mod.init_params(mt.init.Xavier())
            weights = mod.get_params()[0]
        else:
            mod.init_params(arg_params=weights)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": 0.05, "momentum": 0.9, "wd": 5e-4})
        before = contrib.nms_keep.launches
        mod.forward_backward(mt.io.DataBatch(
            [mt.nd.array(x, ctx=mt.cpu())], [mt.nd.array(lab, ctx=mt.cpu())]))
        mod.update()
        if ctx.device_type == "gpu":
            torch.cuda.synchronize()
            assert contrib.nms_keep.launches == before + 1
        got.append(([o.asnumpy() for o in mod.get_outputs()],
                    {k: v.asnumpy() for k, v in mod.get_params()[0].items()}))
    (go, gw), (co, cw) = got
    assert np.array_equal(go[2], co[2])
    for i in (0, 1):
        assert np.abs(go[i] - co[i]).max() <= 1e-5, i
    for k in cw:
        assert np.abs(gw[k] - cw[k]).max() <= 1e-5, k


def test_record_iter_fit_on_gpu_and_the_eval_epilogue(cuda, tmp_path,
                                                      monkeypatch):
    """ImageRecordIter (crop, mirror, means; 64 JPEGs) through ResizeIter
    into Module.fit of a resnet-18 at 32x32 on gpu(0), 2 epochs of 3
    steps, Accuracy and TopKAccuracy(5) on the device, the val .rec
    scored each epoch; then the evaluation forward on a record batch:
    one epilogue launch per fused site, within 1e-5 of the plain
    epilogue."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    from mxtpu_torch.ops import epilogue as epi
    from mxtpu_torch.ops import nn as nn_ops
    monkeypatch.setattr(torch.backends.cudnn, "allow_tf32", False)
    path = mt.test_utils.make_rec(str(tmp_path / "t.rec"), 64, edge=40,
                                  num_classes=3)
    kw = dict(path_imgrec=path, data_shape=(3, 32, 32), batch_size=16,
              mean_r=123.68, mean_g=116.779, mean_b=103.939)
    train = mt.io.ImageRecordIter(shuffle=True, rand_crop=True,
                                  rand_mirror=True, **kw)
    val = mt.io.ImageRecordIter(**kw)
    net = mt.models.get_resnet(num_classes=10, num_layers=18,
                               image_shape=(3, 32, 32))
    mod = mt.mod.Module(net, context=mt.gpu(0))
    np.random.seed(0)
    metric = mt.metric.CompositeEvalMetric(
        [mt.metric.Accuracy(), mt.metric.TopKAccuracy(top_k=5)])
    mod.fit(mt.io.ResizeIter(train, 3), eval_data=val, num_epoch=2,
            eval_metric=metric, optimizer="sgd",
            optimizer_params={"learning_rate": 0.1, "momentum": 0.9})
    names = [n for n, _ in metric.get_name_value()]
    assert names == ["accuracy", "top_k_accuracy_5"]
    assert all(np.isfinite(v) for _, v in metric.get_name_value())
    val.reset()
    batch = val.next()
    before = epi.bn_apply_relu_add.launches
    mod.forward(batch, is_train=False)
    got = mod.get_outputs()[0]._data.clone()
    torch.cuda.synchronize()
    sites = mod._exec_group.execs[0].fused_sites
    assert sites > 0 and epi.bn_apply_relu_add.launches == before + sites
    kernel = nn_ops.bn_apply_relu_add
    nn_ops.bn_apply_relu_add = lambda x, scale, shift, residual=None, \
        axis=-1, **_: epi.bn_apply_relu_add_reference(x, scale, shift,
                                                      residual, axis)
    try:
        mod.forward(batch, is_train=False)
        want = mod.get_outputs()[0]._data
    finally:
        nn_ops.bn_apply_relu_add = kernel
    assert float((got - want).abs().max()) <= 1e-5
    train.close()
    val.close()


def test_top_k_accuracy_accumulates_on_the_card(cuda):
    """TopKAccuracy's device kernel on CUDA predictions (ties included)
    through DeviceMetricAccum: one host copy, the host path's sums."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    rng = np.random.RandomState(3)
    host, dev = (mt.metric.TopKAccuracy(top_k=5) for _ in range(2))
    accum = mt.metric.DeviceMetricAccum.wrap(dev)
    for _ in range(3):
        lab = rng.randint(0, 1000, 64).astype(np.float32)
        pred = rng.rand(64, 1000).astype(np.float32)
        pred[:4] = 0.25
        host.update([mt.nd.array(lab, ctx=mt.cpu())],
                    [mt.nd.array(pred, ctx=mt.cpu())])
        accum.update([torch.from_numpy(lab)],
                     [torch.from_numpy(pred).cuda()])
    accum.sync()
    assert accum.syncs == 1
    assert (dev.sum_metric, dev.num_inst) == (host.sum_metric,
                                              host.num_inst)


def test_det_record_iter_feeds_the_ssd_on_gpu(cuda, tmp_path):
    """ImageDetRecordIter (shuffle, mean_pixels, rand_mirror_prob 0.5, as
    examples/ssd/train.py sets it) into the tiny SSD's Module.fit on
    gpu(0): a finite loss, the suppression kernel once a step."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    from mxtpu_torch.models import ssd_data
    from mxtpu_torch.ops import contrib
    path = mt.test_utils.make_det_rec(str(tmp_path / "d.rec"), 16, edge=64,
                                      num_classes=3)
    it = mt.io.ImageDetRecordIter(
        path_imgrec=path, data_shape=(3, 64, 64), batch_size=4,
        shuffle=True, mean_pixels=(123, 117, 104), rand_mirror_prob=0.5)
    mod = mt.mod.Module(mt.models.ssd.get_symbol_train(
        num_classes=3, num_scales=3, network="tiny"),
        label_names=("label",), context=mt.gpu(0))
    metric = ssd_data.MultiBoxMetric()
    before = contrib.nms_keep.launches
    np.random.seed(1)
    mod.fit(it, num_epoch=2, eval_metric=metric, optimizer="sgd",
            optimizer_params={"learning_rate": 0.01, "momentum": 0.9},
            initializer=mt.init.Xavier())
    torch.cuda.synchronize()
    assert contrib.nms_keep.launches == before + 8
    assert all(np.isfinite(v) for _, v in metric.get_name_value())
    it.close()


# ---------------------------------------------------------------- ROADMAP
# C.8-C.13 and A.14 on the card: each case the same op on a CUDA tensor
# and on cpu(), or held by its statistics
_TIES = [-1.0, 0.0, -0.0, 2.0, 0.5]
_TIE_GRADS = {
    "relu": lambda mt, x: mt.nd.relu(x),
    "Activation(relu)": lambda mt, x: mt.nd.Activation(x, act_type="relu"),
    "abs": lambda mt, x: mt.nd.abs(x),
    "x ** 0": lambda mt, x: x ** 0,
    "x ** 0.5": lambda mt, x: x ** 0.5,
    "0 ** x": lambda mt, x: 0 ** x,
    "-2 ** x": lambda mt, x: (-2) ** x,
    "power(x, x)": lambda mt, x: mt.nd.power(x, x)}


@pytest.mark.parametrize("name", sorted(_TIE_GRADS))
def test_gradients_at_ties_on_the_card_match_cpu(cuda, name):
    import numpy as np
    import mxtpu_torch as mt

    def grad(ctx):
        x = mt.nd.array(np.array(_TIES, np.float32), ctx=ctx)
        x.attach_grad()
        with mt.autograd.record():
            y = _TIE_GRADS[name](mt, x)
        y.backward()
        return x.grad.asnumpy()

    np.testing.assert_array_equal(grad(mt.gpu(0)), grad(mt.cpu()))


_INT_EXPRS = ["i + 0.5", "i - 0.7", "0.7 - i", "i * 2.5", "i / 2", "2 / i",
              "i ** 2.0", "i == 0.5", "u + 10", "u - 5", "u * 1.5",
              "u + 255.9", "h + 0.1", "b * 3.3", "i.sum()", "u.sum()",
              "c.sum(axis=1)", "i.mean()", "u.mean()", "c.mean(axis=0)",
              "big.sum()"]


@pytest.mark.parametrize("expr", _INT_EXPRS)
def test_integer_and_low_precision_arithmetic_on_the_card(cuda, expr):
    import numpy as np
    import mxtpu_torch as mt

    def run(ctx):
        env = {"i": mt.nd.array(np.array([7, 1, -3], np.int32), ctx=ctx),
               "u": mt.nd.array(np.array([250, 3, 9], np.uint8), ctx=ctx),
               "c": mt.nd.array(np.arange(12, dtype=np.int8).reshape(3, 4),
                                ctx=ctx),
               "h": mt.nd.array(np.linspace(0, 1, 5, dtype=np.float16),
                                ctx=ctx),
               "b": mt.nd.array(np.linspace(0, 1, 5), ctx=ctx,
                                dtype="bfloat16"),
               "big": mt.nd.array(np.array([2 ** 30, 2 ** 30], np.int32),
                                  ctx=ctx)}
        return eval(expr, env)

    got, want = run(mt.gpu(0)), run(mt.cpu())
    assert got.context == mt.gpu(0) and got._data.is_cuda
    assert got.dtype == want.dtype and got._data.dtype == want._data.dtype
    if got.dtype.kind == "f" and "mean" in expr:
        # a mean may round one ulp apart (the card's reduction order)
        np.testing.assert_allclose(got.asnumpy(), want.asnumpy(), rtol=1e-6)
    else:
        np.testing.assert_array_equal(got.asnumpy(), want.asnumpy())


@pytest.mark.parametrize("dt", ["float32", "float16", "int32", "int8",
                                "uint8", "bfloat16"])
def test_numpy_dtypes_in_and_out_on_the_card(cuda, dt):
    import numpy as np
    import mxtpu_torch as mt
    reg = mt.ops.registry
    typ = reg.BFLOAT16 if dt == "bfloat16" else np.dtype(dt)
    for arr in (mt.nd.zeros((2, 3), ctx=mt.gpu(0), dtype=typ),
                mt.nd.ones((2, 3), ctx=mt.gpu(0), dtype=typ),
                mt.nd.full((2, 3), 7, ctx=mt.gpu(0), dtype=typ),
                mt.nd.array([[1, 2, 3]], ctx=mt.gpu(0), dtype=typ)):
        assert arr.dtype == typ and arr._data.is_cuda
        assert mt.nd.array(arr).dtype == typ  # an NDArray keeps its type
    a = mt.nd.array(np.arange(4, dtype=np.int64), ctx=mt.gpu(0))
    assert a.dtype == np.int32 and a.asnumpy().dtype == np.int32


def test_uint32_sums_reach_the_host(cuda):
    """An integer sum of uint8 is uint32, a type torch supports only in
    part: it is made, copied and read back on the card."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    u = mt.nd.array(np.full((3, 100), 200, np.uint8), ctx=mt.gpu(0))
    s = u.sum(axis=1)
    assert s._data.dtype == torch.uint32 and s.dtype == np.uint32
    np.testing.assert_array_equal(s.asnumpy(), np.full(3, 20000, np.uint32))


_CARD_OPTIMIZERS = [
    ("adadelta", {"rho": 0.9}), ("adamax", {"learning_rate": 0.01}),
    ("nadam", {"learning_rate": 0.01}), ("ftrl", {"learning_rate": 0.1}),
    ("dcasgd", {"learning_rate": 0.1, "momentum": 0.9}), ("test", {}),
    ("ccsgd", {"learning_rate": 0.1, "momentum": 0.9}),
    ("sgd", {"learning_rate": 0.1, "momentum": 0.9,
             "multi_precision": True})]


@pytest.mark.parametrize("name,params", _CARD_OPTIMIZERS,
                         ids=[c[0] + ("_mp" if c[1].get("multi_precision")
                                      else "") for c in _CARD_OPTIMIZERS])
def test_optimizer_updates_on_the_card_match_cpu(cuda, name, params):
    """4 Updater steps with wd, clip_gradient and rescale_grad on gpu(0)
    against cpu(): weights and states within 1e-6 of their largest value
    (float16 weights: one float16 step)."""
    import numpy as np
    import mxtpu_torch as mt
    rng = np.random.RandomState(5)
    w0 = rng.randn(64, 33).astype(np.float32)
    grads = [rng.randn(64, 33).astype(np.float32) for _ in range(4)]
    dtype = "float16" if params.get("multi_precision") else "float32"

    def run(ctx):
        opt = mt.optimizer.create(name, wd=0.01, clip_gradient=0.8,
                                  rescale_grad=0.5, **params)
        upd = mt.optimizer.get_updater(opt)
        w = mt.nd.array(w0, ctx=ctx, dtype=dtype)
        for g in grads:
            upd(0, mt.nd.array(g, ctx=ctx, dtype=dtype), w)
        st = upd.states[0]
        return [w] + [s for s in (st if isinstance(st, tuple) else (st,))
                      if s is not None]

    got, want = run(mt.gpu(0)), run(mt.cpu())
    assert len(got) == len(want)
    tol = 1e-3 if dtype == "float16" else 1e-6
    for a, b in zip(got, want):
        assert a._data.is_cuda and a.dtype == b.dtype
        b = b.asnumpy().astype(np.float64)
        err = np.abs(a.asnumpy().astype(np.float64) - b).max()
        assert err <= tol * np.abs(b).max(), (name, err)


def test_sgld_noise_on_the_card(cuda):
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    lr, shape = 0.04, (512, 512)
    w = mt.nd.zeros(shape, ctx=mt.gpu(0))
    upd = mt.optimizer.get_updater(mt.optimizer.create("sgld",
                                                       learning_rate=lr))
    upd(0, mt.nd.zeros(shape, ctx=mt.gpu(0)), w)
    x, n = w._data.double(), w.size
    assert w._data.is_cuda
    assert abs(float(x.mean())) < 5 * np.sqrt(lr / n)
    assert abs(float(x.var()) - lr) < 5 * lr * np.sqrt(2.0 / n)


@pytest.mark.parametrize("name", ["MAE", "MSE", "RMSE", "Loss"])
def test_metric_kernels_on_the_card_match_the_host(cuda, name):
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    rng = np.random.RandomState(7)
    host, dev = (getattr(mt.metric, name)() for _ in range(2))
    accum = mt.metric.DeviceMetricAccum.wrap(dev)
    for _ in range(3):
        lab = rng.rand(64, 10).astype(np.float32)
        pred = rng.rand(64, 10).astype(np.float32)
        host.update([mt.nd.array(lab, ctx=mt.cpu())],
                    [mt.nd.array(pred, ctx=mt.cpu())])
        accum.update([torch.from_numpy(lab)],
                     [torch.from_numpy(pred).cuda()])
    accum.sync()
    assert accum.syncs == 1 and dev.num_inst == host.num_inst
    assert abs(dev.sum_metric - host.sum_metric) <= \
        1e-6 * abs(host.sum_metric)


# (sampler, kwargs of the mx.random function or the op's row
# parameters, analytic mean, variance)
_CARD_SAMPLERS = [
    ("uniform", {"low": -1.0, "high": 3.0}, 1.0, 16 / 12.0),
    ("normal", {"loc": 0.5, "scale": 2.0}, 0.5, 4.0),
    ("gamma", {"alpha": 2.5, "beta": 0.5}, 1.25, 0.625),
    ("exponential", {"lam": 4.0}, 0.25, 1 / 16.0),
    ("poisson", {"lam": 3.5}, 3.5, 3.5),
    ("negative_binomial", {"k": 3, "p": 0.4}, 4.5, 11.25),
    ("generalized_negative_binomial", {"mu": 2.0, "alpha": 0.5}, 2.0, 4.0),
    ("sample_uniform", (-1.0, 3.0), 1.0, 16 / 12.0),
    ("sample_normal", (0.5, 2.0), 0.5, 4.0),
    ("sample_gamma", (2.5, 0.5), 1.25, 0.625),
    ("sample_exponential", (4.0,), 0.25, 1 / 16.0),
    ("sample_poisson", (3.5,), 3.5, 3.5),
    ("sample_negative_binomial", (3.0, 0.4), 4.5, 11.25),
    ("sample_generalized_negative_binomial", (2.0, 0.5), 2.0, 4.0)]


@pytest.mark.parametrize("name,kw,mean,var", _CARD_SAMPLERS,
                         ids=[c[0] for c in _CARD_SAMPLERS])
def test_samplers_on_the_card_by_moments(cuda, name, kw, mean, var):
    """2^20 draws on gpu(0): mean and variance within 5 standard errors,
    the same seed the same bits."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    n = 1 << 20

    def draw():
        mt.random.seed(11)
        if not name.startswith("sample_"):
            return getattr(mt.random, name)(shape=(n,), ctx=mt.gpu(0), **kw)
        args = [mt.nd.array(np.full((4,), p, np.float32), ctx=mt.gpu(0))
                for p in kw]
        return getattr(mt.nd, name)(*args, shape=(n // 4,))

    a = draw()
    assert a._data.is_cuda and a.size == n
    assert torch.equal(a._data, draw()._data)
    x = a._data.double().reshape(-1)
    m, v = float(x.mean()), float(x.var(unbiased=False))
    m4 = float(((x - m) ** 4).mean())
    assert abs(m - mean) < 5 * np.sqrt(var / n)
    assert abs(v - var) < 5 * np.sqrt(max(m4 - var ** 2, 1e-30) / n)


def test_multinomial_on_the_card(cuda):
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    probs = np.array([[0.1, 0.2, 0.7], [0.5, 0.25, 0.25]], np.float32)
    n = 1 << 18
    draws, logp = mt.random.multinomial(
        mt.nd.array(probs, ctx=mt.gpu(0)), shape=(n,), get_prob=True)
    assert draws._data.is_cuda and draws.dtype == np.int32
    d = draws.asnumpy()
    for row in range(2):
        freq = np.bincount(d[row], minlength=3) / n
        se = np.sqrt(probs[row] * (1 - probs[row]) / n)
        assert (np.abs(freq - probs[row]) < 5 * se).all()
        np.testing.assert_allclose(logp.asnumpy()[row],
                                   np.log(probs[row][d[row]]), rtol=1e-5)


# ---------------------------------------------------------------- ROADMAP
# A.7's tensor/nn tranche and A.15 on the card: every new op's case of
# op_tranche_cases.py on CUDA tensors against cpu(), indices out of range
# leaving the context usable, Conv2DTranspose, the Gluon zoo
from op_tranche_cases import CASES as _TRANCHE  # noqa: E402


def _tranche_run(torch, mt, name, arrays, attrs, diff, device):
    """The op's outputs and, where ``diff`` names inputs, their gradients
    under a seeded head gradient, on ``device``."""
    import numpy as np
    xs = [torch.from_numpy(a.copy()).to(device) for a in arrays]
    for i in diff:
        xs[i].requires_grad_()
    op = mt.ops.registry.get_op(name)
    outs = op.apply(op.parse_attrs(dict(attrs)), xs, device)
    grads = []
    if diff and outs[0].requires_grad:
        head = torch.from_numpy(np.asarray(np.random.RandomState(7).randn(
            *outs[0].shape), np.float32)).to(device)
        grads = torch.autograd.grad(outs[0], [xs[i] for i in diff],
                                    head.to(outs[0].dtype),
                                    allow_unused=True)
    return ([o.detach().cpu() for o in outs],
            [None if g is None else g.cpu() for g in grads])


def _tranche_close(torch, got, want, tol):
    assert got.dtype == want.dtype and got.shape == want.shape
    if not want.is_floating_point():
        assert torch.equal(got, want)
        return
    g, w = got.double(), want.double()
    assert torch.equal(torch.isnan(g), torch.isnan(w))
    inf = torch.isinf(w)
    assert torch.equal(g[inf], w[inf])
    fin = ~torch.isnan(w) & ~inf
    if bool(fin.any()):
        scale = max(1.0, float(w[fin].abs().max()))
        assert float((g[fin] - w[fin]).abs().max()) <= tol * scale


@pytest.mark.parametrize("name,arrays,attrs,diff", _TRANCHE,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(_TRANCHE)])
def test_tranche_op_on_the_card_matches_cpu(cuda, name, arrays, attrs, diff):
    """Each case of the tranche on CUDA tensors: the forward within 1e-5
    and the gradient within 1e-4 of the largest (TF32 off), the same
    dtypes, NaN and infinity positions, integers equal."""
    torch, _ = cuda
    import mxtpu_torch as mt
    torch.backends.cudnn.allow_tf32 = False
    outs, grads = _tranche_run(torch, mt, name, arrays, attrs, diff, "cuda")
    torch.cuda.synchronize()
    ref_outs, ref_grads = _tranche_run(torch, mt, name, arrays, attrs, diff,
                                       "cpu")
    for got, want in zip(outs, ref_outs):
        _tranche_close(torch, got, want, 1e-5)
    assert len(grads) == len(ref_grads)
    for got, want in zip(grads, ref_grads):
        assert (got is None) == (want is None)
        if got is not None:
            _tranche_close(torch, got, want, 1e-4)


def test_out_of_range_indices_leave_the_context_usable(cuda):
    """one_hot, gather_nd, batch_take and scatter_nd on indices far out
    of range, NaN and huge floats: the answers equal the host's, and
    the CUDA context still runs kernels afterwards (no device assert)."""
    torch, _ = cuda
    import mxtpu_torch as mt
    inv = mt.ops.registry.invoke
    bad = [-7.0, -1.0, 3.0, 1e10, -1e10, float("nan"), 2.0 ** 40, 0.0]
    data = torch.arange(12.0).reshape(3, 4)
    cases = [
        ("one_hot", lambda d: [torch.tensor(bad, device=d)], {"depth": 3}),
        ("gather_nd", lambda d: [data.to(d), torch.tensor(
            [bad, bad[::-1]], device=d)], {}),
        ("batch_take", lambda d: [torch.arange(24.0).reshape(8, 3).to(d),
                                  torch.tensor(bad, device=d)], {}),
        ("scatter_nd", lambda d: [torch.ones(8, device=d), torch.tensor(
            [bad, bad[::-1]], device=d)], {"shape": (3, 4)}),
        ("take", lambda d: [data.to(d), torch.tensor(bad[:5], device=d)],
         {})]
    for name, ins, attrs in cases:
        (got,) = inv(name, ins("cuda"), attrs)[2]
        torch.cuda.synchronize()
        (want,) = inv(name, ins("cpu"), attrs)[2]
        assert torch.equal(torch.isnan(got.cpu()), torch.isnan(want)), name
        assert torch.equal(torch.nan_to_num(got.cpu()),
                           torch.nan_to_num(want)), name
    z = torch.ones(1000, device="cuda") * 2
    torch.cuda.synchronize()
    assert float(z.sum()) == 2000.0


def test_ndarray_surface_of_the_tranche_on_the_card(cuda):
    """``a % b``, ``nd.clip``, ``nd.dot`` and ``nd.topk`` on gpu(0) equal
    cpu()'s, and stay on the card."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    x = np.array([[5.5, -3.0, 2.0], [0.0, 7.0, -1.5]], np.float32)
    y = np.array([[2.0, 2.0, -3.0], [1.5, 4.0, 2.0]], np.float32)

    def body(ctx):
        a, b = mt.nd.array(x, ctx=ctx), mt.nd.array(y, ctx=ctx)
        i = mt.nd.array(np.array([5, -5, 7], np.int32), ctx=ctx)
        res = [a % b, a % 2.5, i % 0, mt.nd.clip(a, 0.0, 5.0),
               mt.nd.dot(a, b.T), mt.nd.topk(a, k=2, ret_typ="both")[1]]
        assert all(r.context == ctx for r in res)
        return [r.asnumpy() for r in res]

    for g, w in zip(body(mt.gpu(0)), body(mt.cpu())):
        np.testing.assert_allclose(g, w, rtol=1e-6)


def test_conv2d_transpose_on_the_card_matches_cpu(cuda):
    """Gluon's Conv2DTranspose (Deconvolution, adj from output_padding,
    groups, a bias) on gpu(0) from the same weights as on cpu():
    forward and gradients within 1e-5 of the largest (cuDNN, TF32 off)."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    torch.backends.cudnn.allow_tf32 = False
    x = np.random.RandomState(0).randn(2, 4, 7, 6).astype(np.float32)
    w = np.random.RandomState(1).randn(4, 3, 3, 3).astype(np.float32)
    b = np.random.RandomState(2).randn(6).astype(np.float32)

    def run(ctx):
        with ctx:
            layer = mt.gluon.nn.Conv2DTranspose(
                6, 3, strides=2, padding=1, output_padding=1, groups=2,
                in_channels=4)
            layer.initialize(ctx=ctx)
            layer.weight.set_data(mt.nd.array(w, ctx=ctx))
            layer.bias.set_data(mt.nd.array(b, ctx=ctx))
            xa = mt.nd.array(x, ctx=ctx)
            xa.attach_grad()
            with mt.autograd.record():
                out = layer(xa)
            out.backward()
            return [out.asnumpy(), xa.grad.asnumpy(),
                    layer.weight.grad(ctx).asnumpy()]

    got, want = run(mt.gpu(0)), run(mt.cpu())
    assert got[0].shape == (2, 6, 14, 12)
    for g, v in zip(got, want):
        np.testing.assert_allclose(g, v, rtol=0,
                                   atol=1e-5 * max(1.0, np.abs(v).max()))


@pytest.mark.parametrize("name,edge", [
    ("alexnet", 63), ("densenet121", 32), ("inceptionv3", 299),
    ("mobilenet1.0", 32), ("squeezenet1.0", 32), ("vgg16_bn", 32)])
def test_gluon_zoo_forward_on_the_card_matches_cpu(cuda, tmp_path, name,
                                                   edge):
    """Each new zoo net of ``get_model``, hybridized, at its narrowest
    input: gpu(0) from the cpu() net's ``.params`` within 1e-4 of the
    largest logit (cuDNN and cuBLAS, TF32 off)."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    torch.backends.cudnn.allow_tf32 = False
    v = mt.gluon.model_zoo.vision
    x = np.random.RandomState(3).rand(2, 3, edge, edge).astype(np.float32)
    with mt.cpu():
        net = v.get_model(name, classes=10)
        net.initialize(mt.init.Xavier(), ctx=mt.cpu())
        net.hybridize()
        want = net(mt.nd.array(x)).asnumpy()
        net.save_params(str(tmp_path / "n.params"))
    card = v.get_model(name, classes=10)
    card.load_params(str(tmp_path / "n.params"), ctx=mt.gpu(0))
    card.hybridize()
    got = card(mt.nd.array(x, ctx=mt.gpu(0)))
    assert got.context == mt.gpu(0)
    np.testing.assert_allclose(got.asnumpy(), want, rtol=0,
                               atol=1e-4 * max(1.0, np.abs(want).max()))


# A.7's second tranche: spatial.py, the Custom op and optimizer_ops on the
# card. ROIPooling's kernel against its plain version on the same card
# tensors (forward bit for bit, backward within 1e-6 of the largest and
# bit-identical on repeat), Proposal with the suppression kernel against
# the plain Proposal on the same card inputs (bit for bit), every spatial
# case on CUDA tensors against cpu(), the Custom op and the update ops,
# and the example Faster R-CNN's step on gpu(0)
from spatial_cases import CASES as _SPATIAL  # noqa: E402
from spatial_cases import (ROI_MANY_TERMS, order_bound,  # noqa: E402
                           ordered_roi_gradient)

_ROI_CASES = [c for c in _SPATIAL if c[0] == "ROIPooling"]


def _roi_kernel_vs_plain(torch, data, rois, pooled, scale):
    from mxtpu_torch.ops import spatial
    before = (spatial.roi_pool.launches, spatial.roi_pool_backward.launches)
    x = data.clone().requires_grad_()
    y = spatial.roi_pool(x, rois, pooled, scale)
    dy = torch.randn(y.shape, generator=torch.Generator(
        device="cuda").manual_seed(3), device="cuda")
    (g1,) = torch.autograd.grad(y, [x], dy, retain_graph=True)
    (g2,) = torch.autograd.grad(y, [x], dy)
    torch.cuda.synchronize()
    assert (spatial.roi_pool.launches, spatial.roi_pool_backward.launches) \
        == (before[0] + 1, before[1] + 2)
    want = spatial.roi_pool_reference(data, rois, pooled, scale)
    assert torch.equal(y.detach(), want)
    gw = spatial.roi_pool_backward_reference(data, rois, dy, pooled, scale)
    assert torch.equal(torch.isnan(g1), torch.isnan(gw))
    fin = ~torch.isnan(gw)
    scale_g = max(1e-30, float(gw[fin].abs().max())) if fin.any() else 1.0
    assert float((g1[fin] - gw[fin]).abs().max()) <= 1e-6 * scale_g
    assert torch.equal(torch.nan_to_num(g1), torch.nan_to_num(g2))


@pytest.mark.parametrize("k", range(len(_ROI_CASES)))
def test_roi_pooling_kernel_equals_plain_version(cuda, k):
    torch, _ = cuda
    _, (data, rois), attrs, _ = _ROI_CASES[k]
    _roi_kernel_vs_plain(torch, torch.from_numpy(data).cuda(),
                         torch.from_numpy(rois).cuda(),
                         attrs["pooled_size"], attrs["spatial_scale"])


@pytest.mark.parametrize("k", range(len(ROI_MANY_TERMS)))
def test_roi_pooling_kernel_sums_many_terms_in_order(cuda, k):
    """A pixel in thousands of bins: the kernel's gradient equals, bit for
    bit, the float32 sum of its terms in (ROI, ph, pw) order on the CPU,
    and the plain version's, which adds them in another order, within the
    bound on two orders' difference (``order_bound``)."""
    import numpy as np
    torch, _ = cuda
    from mxtpu_torch.ops import spatial
    (data, rois), attrs = ROI_MANY_TERMS[k]
    pooled, scale = attrs["pooled_size"], attrs["spatial_scale"]
    x = torch.from_numpy(data).cuda().requires_grad_()
    r = torch.from_numpy(rois).cuda()
    dy = np.random.RandomState(7).randn(
        rois.shape[0], data.shape[1], *pooled).astype(np.float32)
    y = spatial.roi_pool(x, r, pooled, scale)
    (g,) = torch.autograd.grad(y, [x], torch.from_numpy(dy).cuda())
    gw = spatial.roi_pool_backward_reference(x.detach(), r,
                                             torch.from_numpy(dy).cuda(),
                                             pooled, scale)
    N, _, H, W = data.shape
    t_rois = torch.from_numpy(rois)
    bins = [b.long().numpy() for b in spatial._roi_bins(
        t_rois, pooled[0], pooled[1], scale, H, W)]
    image = spatial._batch_index(t_rois[:, 0], N).numpy()
    want, terms, mag = ordered_roi_gradient(data, image, bins, dy)
    assert terms.max() > 1000
    got = g.cpu().numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))
    assert np.all(np.abs(gw.cpu().numpy().astype(np.float64) - want)
                  <= order_bound(terms, mag))


def test_roi_pooling_kernel_at_the_training_shape(cuda):
    """chip_smoke.py's phase-16 inputs: 256 ROIs over the ReLU'd
    2x512x37x62 map, 7x7 at 1/16, a quarter with .5 corners."""
    torch, _ = cuda
    import chip_smoke
    cfg = chip_smoke.ROI_TIMED
    _roi_kernel_vs_plain(torch, *chip_smoke.roi_inputs(
        0, cfg["rois"], cfg["channels"], cfg["shape"], cfg["image"],
        cfg["pooled"]))


def test_roi_pooling_kernel_at_the_test_forward_shape(cuda):
    """The test symbol's forward: 2 x 300 ROIs over the 2x512x37x62 map,
    one forward launch, bit for bit with the plain version."""
    torch, _ = cuda
    import chip_smoke
    from mxtpu_torch.ops import spatial
    cfg = chip_smoke.ROI_TIMED
    data, rois, pooled, scale = chip_smoke.roi_inputs(
        1, cfg["test_rois"], cfg["channels"], cfg["shape"], cfg["image"],
        cfg["pooled"])
    before = spatial.roi_pool.launches
    y = spatial.roi_pool(data, rois, pooled, scale)
    torch.cuda.synchronize()
    assert spatial.roi_pool.launches == before + 1
    assert y.shape == (600, 512, 7, 7)
    assert torch.equal(y, spatial.roi_pool_reference(data, rois, pooled,
                                                     scale))


def test_roi_pooling_kernel_refuses_what_it_does_not_take(cuda):
    torch, _ = cuda
    import mxtpu_torch as mt
    from mxtpu_torch.ops import spatial
    x = torch.rand(1, 2, 4, 4, device="cuda")
    r = torch.tensor([[0, 0, 0, 3, 3]], dtype=torch.float32, device="cuda")
    with pytest.raises(mt.MXNetError, match="float32"):
        spatial.roi_pool(x.double(), r.double(), (2, 2), 1.0)
    with pytest.raises(mt.MXNetError, match="contiguous"):
        spatial.roi_pool(x.transpose(2, 3), r, (2, 2), 1.0)
    with pytest.raises(mt.MXNetError, match="CUDA"):
        spatial.roi_pool(x, r.cpu(), (2, 2), 1.0)


def _proposal_on_card(torch, monkeypatch, arrays, attrs):
    """Proposal on CUDA tensors with the suppression kernel, and again
    with the plain sweep on the same tensors."""
    import mxtpu_torch as mt
    from mxtpu_torch.ops import contrib, spatial
    xs = [a.cuda() if isinstance(a, torch.Tensor) else
          torch.from_numpy(a).cuda() for a in arrays]
    before = contrib.nms_keep.launches
    _, _, got = mt.ops.registry.invoke("_contrib_Proposal", xs, dict(attrs))
    torch.cuda.synchronize()
    assert contrib.nms_keep.launches == before + 1
    monkeypatch.setattr(spatial, "nms_keep", contrib.nms_keep_reference)
    _, _, want = mt.ops.registry.invoke("_contrib_Proposal", xs, dict(attrs))
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    return got


@pytest.mark.parametrize("k", [i for i, c in enumerate(_SPATIAL)
                               if "Proposal" in c[0]])
def test_proposal_on_the_card_equals_the_plain_proposal(cuda, monkeypatch,
                                                        k):
    torch, _ = cuda
    _, arrays, attrs, _ = _SPATIAL[k]
    _proposal_on_card(torch, monkeypatch, arrays, attrs)


@pytest.mark.parametrize("pre,post", [(12000, 2000), (6000, 300)])
def test_proposal_at_the_vgg16_shape(cuda, monkeypatch, pre, post):
    """The Faster R-CNN's Proposal: 2 images, 9 anchors over 37 x 62, K =
    12,000 (training) and 6,000 (test) into the suppression kernel."""
    torch, _ = cuda
    g = torch.Generator(device="cuda").manual_seed(5)
    score = torch.randn(2, 2, 9 * 37 * 62, generator=g, device="cuda")
    prob = torch.softmax(score, 1).reshape(2, 18, 37, 62)
    bbox = 0.2 * torch.randn(2, 36, 37, 62, generator=g, device="cuda")
    info = torch.tensor([[600, 1000, 1.0]] * 2, device="cuda")
    attrs = {"feature_stride": 16, "scales": (8, 16, 32),
             "ratios": (0.5, 1, 2), "rpn_pre_nms_top_n": pre,
             "rpn_post_nms_top_n": post, "threshold": 0.7,
             "rpn_min_size": 16}
    (rois,) = _proposal_on_card(torch, monkeypatch, [prob, bbox, info],
                                attrs)
    assert rois.shape == (2 * post, 5)


@pytest.mark.parametrize("name,arrays,attrs,diff", _SPATIAL,
                         ids=["%s-%d" % (c[0], i)
                              for i, c in enumerate(_SPATIAL)])
def test_spatial_op_on_the_card_matches_cpu(cuda, name, arrays, attrs, diff):
    """Each spatial case on CUDA tensors (the kernels where the op has
    them): forward within 1e-5 and gradient within 1e-4 of the largest,
    NaN and infinity positions equal."""
    torch, _ = cuda
    import mxtpu_torch as mt
    torch.backends.cudnn.allow_tf32 = False
    outs, grads = _tranche_run(torch, mt, name, arrays, attrs, diff, "cuda")
    torch.cuda.synchronize()
    ref_outs, ref_grads = _tranche_run(torch, mt, name, arrays, attrs, diff,
                                       "cpu")
    for got, want in zip(outs, ref_outs):
        _tranche_close(torch, got, want, 1e-5)
    for got, want in zip(grads, ref_grads):
        assert (got is None) == (want is None)
        if got is not None:
            _tranche_close(torch, got, want, 1e-4)


def test_custom_op_and_update_ops_on_the_card(cuda):
    """A numpy CustomOp inside autograd on gpu(0) (its outputs on the
    card), and the eight update ops on CUDA tensors, against cpu()."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    class Sigmoid(mt.operator.CustomOp):
        def forward(self, is_train, req, in_data, out_data, aux):
            self.assign(out_data[0], req[0],
                        1 / (1 + np.exp(-in_data[0].asnumpy())))

        def backward(self, req, out_grad, in_data, out_data, in_grad, aux):
            y = out_data[0].asnumpy()
            self.assign(in_grad[0], req[0],
                        out_grad[0].asnumpy() * y * (1 - y))

    @mt.operator.register("card_sigmoid")
    class SigmoidProp(mt.operator.CustomOpProp):
        def create_operator(self, ctx, shapes, dtypes):
            return Sigmoid()

    x = np.random.RandomState(0).randn(3, 4).astype(np.float32)
    grads = []
    for ctx in (mt.gpu(0), mt.cpu()):
        a = mt.nd.array(x, ctx=ctx)
        a.attach_grad()
        with mt.autograd.record():
            y = mt.nd.Custom(a, op_type="card_sigmoid")
        y.backward()
        assert y.context == ctx
        grads.append((y.asnumpy(), a.grad.asnumpy()))
    np.testing.assert_allclose(grads[0][0], grads[1][0], rtol=1e-6)
    np.testing.assert_allclose(grads[0][1], grads[1][1], rtol=1e-6)
    from update_op_cases import UPDATE_CASES
    for name, arrays, attrs in UPDATE_CASES:
        got = mt.ops.registry.invoke(
            name, [torch.from_numpy(a).cuda() for a in arrays], attrs)[2]
        want = mt.ops.registry.invoke(
            name, [torch.from_numpy(a) for a in arrays], attrs)[2]
        for g, w in zip(got, want):
            np.testing.assert_allclose(g.cpu().numpy(), w.numpy(),
                                       rtol=1e-5, atol=1e-6)


def test_example_rcnn_step_on_gpu(cuda):
    """The example Faster R-CNN's training step through Module on gpu(0):
    finite losses, one ROIPooling forward and backward launch and one
    suppression launch a step, the RPN's class output against cpu()
    within 1e-4 (the proposals themselves may differ: a card forward and
    a CPU one reorder near-tied scores)."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    from mxtpu_torch.models import rcnn
    from mxtpu_torch.ops import contrib, spatial
    torch.backends.cudnn.allow_tf32 = False
    cfg = rcnn.CONFIGS["example"]
    arrays = rcnn.make_batch(np.random.RandomState(5), 2, cfg)
    outs = []
    for ctx in (mt.gpu(0), mt.cpu()):
        mt.random.seed(1)
        mod = mt.mod.Module(rcnn.build_train_symbol(cfg), context=ctx,
                            data_names=rcnn.DATA_NAMES,
                            label_names=rcnn.LABEL_NAMES)
        mod.bind(data_shapes=rcnn.data_shapes(cfg, 2),
                 label_shapes=rcnn.label_shapes(cfg, 2))
        np.random.seed(3)
        mod.init_params(mt.initializer.Xavier())
        before = (spatial.roi_pool.launches,
                  spatial.roi_pool_backward.launches,
                  contrib.nms_keep.launches)
        mod.forward_backward(rcnn.batch_of(arrays, ctx))
        got = [o.asnumpy() for o in mod.get_outputs()]
        after = (spatial.roi_pool.launches,
                 spatial.roi_pool_backward.launches,
                 contrib.nms_keep.launches)
        if ctx.device_type == "gpu":
            assert [a - b for a, b in zip(after, before)] == [1, 1, 1]
        assert all(np.isfinite(o).all() for o in got)
        outs.append(got)
    np.testing.assert_allclose(outs[0][0], outs[1][0], atol=1e-4)


# A.7's last names and A.4.3: linalg.py, the rest of contrib.py and the
# sparse NDArray on the card. Every linalg and contrib case of
# final_op_cases.py on CUDA tensors against cpu(); the CTC kernel pair
# against its plain version on the same card tensors (the loss within
# 1e-5 relative, 1e30 where the plain version gives it, the gradient
# within 1e-5 of the largest, NaN at the same places, bit-identical on
# repeat, one launch each a call) at every CTC case and a speech shape,
# and its refusals; Gluon's CTCLoss under autograd; the sparse dots and
# row_sparse_pull with the store on the card
from final_op_cases import CONTRIB_CASES as _CONTRIB  # noqa: E402
from final_op_cases import CTC_CASES as _CTC  # noqa: E402
from final_op_cases import LINALG_CASES as _LINALG  # noqa: E402
from final_op_cases import SPARSE_FAULTS as _SPARSE_FAULTS  # noqa: E402
from final_op_cases import ctc_inputs as _ctc_inputs  # noqa: E402


def _final_op(torch, name, arrays, attrs, diff, outs, device):
    import numpy as np
    import mxtpu_torch as mt
    xs = [torch.from_numpy(a.copy()).to(device) for a in arrays]
    for i in diff:
        xs[i].requires_grad_()
    op = mt.ops.registry.get_op(name)
    res = op.apply(op.parse_attrs(dict(attrs)), xs, device)
    grads = []
    if diff:
        rng = np.random.RandomState(7)
        heads = [torch.from_numpy(rng.randn(*res[k].shape).astype(
            np.float32)).to(device) for k in outs]
        grads = list(torch.autograd.grad([res[k] for k in outs],
                                         [xs[i] for i in diff], heads))
    return [t.detach().cpu() for t in list(res) + grads], len(res)


@pytest.mark.parametrize("name,arrays,attrs,diff,outs", _LINALG + _CONTRIB,
                         ids=["%s-%d" % (c[0], i) for i, c in
                              enumerate(_LINALG + _CONTRIB)])
def test_final_ops_on_the_card_match_cpu(cuda, name, arrays, attrs, diff,
                                         outs):
    torch, _ = cuda
    got, n_out = _final_op(torch, name, arrays, attrs, diff, outs, "cuda")
    torch.cuda.synchronize()
    want, _ = _final_op(torch, name, arrays, attrs, diff, outs, "cpu")
    assert len(got) == len(want)
    for j, (g, w) in enumerate(zip(got, want)):
        assert g.dtype == w.dtype and g.shape == w.shape
        if not w.is_floating_point():
            assert torch.equal(g, w)
            continue
        assert torch.equal(torch.isnan(g), torch.isnan(w))
        fin = ~torch.isnan(w)
        tol = 1e-5 if j < n_out else 1e-4
        if fin.any():
            scale = max(1.0, float(w[fin].abs().max()))
            assert float((g[fin] - w[fin]).abs().max()) <= tol * scale, j


def _ctc_kernel_vs_plain(torch, x, lab, blank_label, dl, ll, head):
    from mxtpu_torch.ops import contrib
    before = (contrib.ctc_loss_fwd.launches, contrib.ctc_loss_bwd.launches)
    runs = []
    for _ in range(2):
        xt = x.clone().requires_grad_()
        loss = contrib.ctc_loss(xt, lab, blank_label, dl, ll)
        (g,) = torch.autograd.grad(loss, [xt], head)
        runs.append((loss.detach(), g))
    torch.cuda.synchronize()
    assert (contrib.ctc_loss_fwd.launches, contrib.ctc_loss_bwd.launches) \
        == (before[0] + 2, before[1] + 2)
    T, N, C = x.shape
    first = blank_label != "last"
    labs, n_lab = contrib.ctc_labels(lab, C, first, ll)
    dlen = torch.full((N,), T, dtype=torch.int32, device="cuda") \
        if dl is None else contrib.int_convert(dl)
    xt = x.clone().requires_grad_()
    want = contrib.ctc_loss_reference(xt, labs, n_lab, dlen,
                                      0 if first else C - 1)
    (want_g,) = torch.autograd.grad(want, [xt], head)
    want = want.detach()
    (loss, g), (loss2, g2) = runs
    assert torch.equal(loss, loss2)
    assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(g2))
    big = want == 1e30
    assert torch.equal(loss == 1e30, big)
    if (~big).any():
        rel = (loss - want).abs() / want.abs().clamp(min=1.0)
        assert float(rel[~big].max()) <= 1e-5
    nan = torch.isnan(want_g)
    assert torch.equal(torch.isnan(g), nan)
    scale = max(1e-30, float(want_g[~nan].abs().max()))
    assert float((g - want_g)[~nan].abs().max()) <= 1e-5 * scale


@pytest.mark.parametrize("case", _CTC, ids=[c[0] for c in _CTC])
def test_ctc_kernels_match_the_plain_version(cuda, case):
    torch, _ = cuda
    name, T, N, C, labels, attrs, dl, ll, nan = case
    x, lab, extra, head = _ctc_inputs(T, N, C, labels, dl, ll, nan)
    it = iter(extra)
    dlt = torch.from_numpy(next(it)).cuda() \
        if attrs.get("use_data_lengths") else None
    llt = torch.from_numpy(next(it)).cuda() \
        if attrs.get("use_label_lengths") else None
    _ctc_kernel_vs_plain(torch, torch.from_numpy(x).cuda(),
                         torch.from_numpy(lab).cuda(),
                         attrs.get("blank_label", "first"), dlt, llt,
                         torch.from_numpy(head).cuda())


@pytest.mark.parametrize("T,N,C,L", [(800, 32, 29, 200), (50, 3, 3000, 600),
                                     (40, 2, 5, 1100), (30, 2, 5, 1900)])
def test_ctc_kernels_at_speech_and_wide_shapes(cuda, T, N, C, L):
    """The speech shape (13 warps of one state a lane); 3,000 classes (a
    wide class row) at 1,201 states (2 a lane); 2,201 and 3,801 states
    (3 and 4 a lane over 32 warps)."""
    import numpy as np
    torch, _ = cuda
    rng = np.random.RandomState(T + C)
    x = torch.from_numpy(rng.randn(T, N, C).astype(np.float32)).cuda()
    lab = rng.randint(1, C, (N, L)).astype(np.float32)
    lab[:, L // 2 + rng.randint(0, L // 2):] = 0
    head = torch.from_numpy((rng.rand(N) + 0.5).astype(np.float32)).cuda()
    _ctc_kernel_vs_plain(torch, x, torch.from_numpy(lab).cuda(), "first",
                         None, None, head)


@pytest.mark.parametrize("case", ["float64", "cpu_labels", "no_labels",
                                  "non_contiguous", "states_past_shared",
                                  "adjoints_past_shared"])
def test_ctc_kernels_refuse_what_they_do_not_take(cuda, case):
    """Inputs the kernels do not take raise; so do sequences whose states
    do not fit a block (more than 4,096: 32 warps of 4 states a lane),
    refused by the forward's and the backward's launchers, after which
    the next launch runs."""
    import mxtpu_torch as mt
    from mxtpu_torch.ops import contrib
    torch, _ = cuda
    x = torch.randn(6, 2, 5, device="cuda")
    lab = torch.tensor([[1.0, 2.0], [3.0, 0.0]], device="cuda")
    if case == "float64":
        with pytest.raises(mt.MXNetError, match="float32"):
            contrib.ctc_loss(x.double(), lab)
        return
    labs, n_lab = contrib.ctc_labels(lab, 5, True)
    dlen = torch.full((2,), 6, dtype=torch.int32, device="cuda")
    logp = torch.log_softmax(x, -1)
    if case.endswith("past_shared"):
        L = 15000 if case == "states_past_shared" else 4000
        labs = torch.ones((2, L), dtype=torch.int32, device="cuda")
        n_lab = torch.full((2,), L, dtype=torch.int32, device="cuda")
        with pytest.raises(mt.MXNetError, match="launch failed"):
            if case == "states_past_shared":
                contrib.ctc_loss_fwd(logp, labs, n_lab, dlen, 0)
            else:
                alpha = torch.zeros((6, 2, 2 * L + 1), device="cuda")
                contrib.ctc_loss_bwd(torch.ones(2, device="cuda"), logp,
                                     alpha, labs, n_lab, dlen, 0)
        labs, n_lab = contrib.ctc_labels(lab, 5, True)
        loss, _ = contrib.ctc_loss_fwd(logp, labs, n_lab, dlen, 0)
        assert bool(torch.isfinite(loss).all())
        return
    if case == "cpu_labels":
        labs = labs.cpu()
    elif case == "no_labels":
        labs = labs[:, :0].contiguous()
    else:
        logp = logp.transpose(0, 1).contiguous().transpose(0, 1)
    with pytest.raises(mt.MXNetError, match="ctc_loss kernels"):
        contrib.ctc_loss_fwd(logp, labs, n_lab, dlen, 0)


def test_gluon_ctc_loss_on_the_card(cuda):
    import numpy as np
    import mxtpu_torch as mt
    from mxtpu_torch.ops import contrib
    torch, _ = cuda
    x, lab, _, _ = _ctc_inputs(7, 3, 5, [[1, 2, 0], [3, 3, 4], [4, 1, 2]],
                               None, None, None, seed=6)
    pred = x.transpose(1, 0, 2).copy()
    outs = []
    for ctx in (mt.gpu(0), mt.cpu()):
        with ctx:
            loss_fn = mt.gluon.loss.CTCLoss()
            loss_fn.hybridize()
            p = mt.nd.array(pred)
            p.attach_grad()
            before = contrib.ctc_loss_fwd.launches
            with mt.autograd.record():
                out = loss_fn(p, mt.nd.array(lab))
            out.backward()
            outs.append((out.asnumpy(), p.grad.asnumpy(),
                         contrib.ctc_loss_fwd.launches - before))
    (lg, gg, launched), (lc, gc, none) = outs
    assert launched == 1 and none == 0
    np.testing.assert_allclose(lg, lc, rtol=1e-5)
    np.testing.assert_allclose(gg, gc, rtol=0, atol=1e-5 * np.abs(gc).max())


def test_sparse_ops_on_the_card(cuda):
    """add (row_sparse and csr), sparse_retain, copy, a row slice, the
    components' rebuild after a dense write and row_sparse_pull on
    gpu(0): every component stays on the card and equals cpu()'s."""
    import contextlib

    import numpy as np
    import mxtpu_torch as mt
    torch, _ = cuda
    from final_op_cases import sparse_device_ops
    outs = []
    for ctx in (mt.gpu(0), mt.cpu()):
        with ctx:
            arrays = sparse_device_ops(mt, contextlib.nullcontext)
        parts = []
        for a in arrays:
            comps = a._components()
            assert all(c.device == ctx.torch_device for c in comps), a
            parts.append([a.stype, a.shape, np.dtype(a.dtype).name]
                         + [c.cpu().numpy() for c in comps])
        outs.append(parts)
    for g, w in zip(*outs):
        assert g[:3] == w[:3]
        for gc, wc in zip(g[3:], w[3:]):
            assert gc.dtype == wc.dtype and gc.shape == wc.shape
            np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-6)


def test_sparse_dots_and_row_sparse_pull_on_the_card(cuda):
    """csr·dense and csrᵀ·dense on the card against the CPU's; a
    row_sparse pull from a store on the card lands there."""
    import numpy as np
    import mxtpu_torch as mt
    torch, _ = cuda
    rng = np.random.RandomState(0)
    dense = rng.randn(64, 500).astype(np.float32)
    dense[rng.rand(64, 500) > 0.05] = 0
    w = rng.randn(500, 3).astype(np.float32)
    e = rng.randn(64, 3).astype(np.float32)
    got, want = [], []
    for ctx, out in ((mt.gpu(0), got), (mt.cpu(), want)):
        with ctx:
            c = mt.nd.sparse.csr_matrix(dense)
            out.append(mt.nd.dot(c, mt.nd.array(w)).asnumpy())
            r = mt.nd.dot(c, mt.nd.array(e), transpose_a=True)
            assert r.data._data.device == ctx.torch_device
            out += [r.indices.asnumpy(), r.data.asnumpy()]
    np.testing.assert_allclose(got[0], want[0], rtol=0, atol=1e-5)
    np.testing.assert_array_equal(got[1], want[1])
    np.testing.assert_allclose(got[2], want[2], rtol=0, atol=1e-5)
    with mt.gpu(0):
        store = mt.kv.create("local")
        store.init("w", mt.nd.array(w))
        rows = mt.nd.sparse.zeros("row_sparse", (500, 3))
        store.row_sparse_pull("w", out=rows, row_ids=mt.nd.array(
            np.array([7.0, 2.0, 7.0])))
    assert rows.data._data.is_cuda
    assert rows.indices.asnumpy().tolist() == [2, 7]
    np.testing.assert_array_equal(rows.data.asnumpy(), w[[2, 7]])


@pytest.mark.parametrize("name,body", _SPARSE_FAULTS,
                         ids=[n for n, _ in _SPARSE_FAULTS])
def test_sparse_faults_on_the_card_match_cpu(cuda, name, body):
    """The in-place writes to sparse arrays, the dots of a CSR array and a
    vector and csr + csr of two types on gpu(0) against cpu(): each
    array's storage, shape, dtype, values and components equal, its
    tensors on its context's device."""
    import numpy as np
    import mxtpu_torch as mt
    torch, _ = cuda
    outs = []
    for ctx in (mt.gpu(0), mt.cpu()):
        with ctx:
            arrays = body(mt)
        parts = []
        for a in arrays:
            comps = a._components() if a.stype != "default" else [a._data]
            assert all(c.device == ctx.torch_device for c in comps), name
            parts.append([a.stype, a.shape, np.dtype(a.dtype).name,
                          a.asnumpy()] + [c.cpu().numpy() for c in comps])
        outs.append(parts)
    for g, w in zip(*outs):
        assert g[:3] == w[:3]
        for gc, wc in zip(g[3:], w[3:]):
            assert gc.dtype == wc.dtype and gc.shape == wc.shape
            np.testing.assert_allclose(gc, wc, rtol=0, atol=1e-6)


def test_float_to_int_conversion_on_the_card_matches_cpu(cuda):
    """``registry.int_convert`` (XLA's convert: NaN to 0, out of range
    saturated, toward zero in between) on CUDA tensors equals the CPU's,
    from float32 and float64 into int32, int8, uint8 and int64; so do
    ``Cast`` and CTC's labels and lengths (``ctc_labels``)."""
    import mxtpu_torch as mt
    from mxtpu_torch.ops import contrib
    from mxtpu_torch.ops.registry import int_convert
    torch, _ = cuda
    nan, inf = float("nan"), float("inf")
    vals = [nan, inf, -inf, 3e9, -3e9, 2.7, -2.7, 2147483647.0,
            -2147483648.0, 0.5, -0.5, 127.9, 255.5, -129.0, 1e20]
    for dt in (torch.float32, torch.float64):
        x = torch.tensor(vals, dtype=dt)
        for it in (torch.int32, torch.int8, torch.uint8, torch.int64):
            assert torch.equal(int_convert(x.cuda(), it).cpu(),
                               int_convert(x, it)), (dt, it)
        for name in ("int32", "uint8"):
            got = mt.ops.registry.invoke("Cast", [x.cuda()],
                                         {"dtype": name})[2][0]
            want = mt.ops.registry.invoke("Cast", [x], {"dtype": name})[2][0]
            assert torch.equal(got.cpu(), want), (dt, name)
    labels = torch.tensor([[1.0, 3e9, nan], [nan, -3e9, 2.0]])
    lengths = torch.tensor([3e9, nan])
    for first in (True, False):
        got = contrib.ctc_labels(labels.cuda(), 5, first, lengths.cuda())
        want = contrib.ctc_labels(labels, 5, first, lengths)
        assert all(torch.equal(g.cpu(), w) for g, w in zip(got, want))


def test_waitall_waits_for_every_card(cuda):
    """ROADMAP C.20: with cuda:0 current, a long kernel on cuda:3 is still
    running when it is launched, and done when ``nd.waitall()`` returns
    (the port once synchronized only the current device)."""
    import mxtpu_torch as mt
    torch, _ = cuda
    _gpus(torch, 4)
    torch.cuda.set_device(0)
    torch.zeros(1, device="cuda:0")
    with torch.cuda.device(3):
        torch.cuda._sleep(int(3e9))  # ~1.5 s of spinning at 2 GHz
        done = torch.cuda.Event()
        done.record()
    assert torch.cuda.current_device() == 0
    assert not done.query()
    mt.nd.waitall()
    assert done.query()


def test_telemetry_adds_no_launch(cuda):
    """A tiny LM's fit on gpu(0) launches the same flash forward and
    backward kernels with telemetry on and off, and its fit series count
    the steps only when on."""
    import logging
    import numpy as np
    import mxtpu_torch as mt
    torch, att = cuda
    sym = mt.models.get_transformer_lm(vocab_size=64, seq_len=128,
                                       num_layers=2, num_heads=2,
                                       d_model=64)
    rng = np.random.RandomState(0)
    ids = rng.randint(0, 64, (2, 129))
    x = ids[:, :-1].astype(np.float32)
    y = ids[:, 1:].reshape(-1).astype(np.float32)

    class Two:
        provide_data = [mt.io.DataDesc("data", x.shape)]
        provide_label = [mt.io.DataDesc("softmax_label", y.shape)]

        def __init__(self):
            self.n = 0

        def __iter__(self):
            return self

        def __next__(self):
            if self.n == 3:
                raise StopIteration
            self.n += 1
            return mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                                   [mt.nd.array(y, ctx=mt.cpu())], pad=0)

        def reset(self):
            self.n = 0

    steps = mt.telemetry.registry().histogram("fit_step_ms")
    runs = []
    for on in (True, False, True):
        mt.telemetry.set_enabled(on)
        try:
            mod = mt.mod.Module(sym, context=mt.gpu(0),
                                logger=logging.getLogger("quiet"))
            att.flash_attention.launches = 0
            att.flash_attention_backward.launches = 0
            n0 = steps.count
            mod.fit(Two(), num_epoch=1, eval_metric="ce", optimizer="adam",
                    initializer=mt.init.Xavier())
            torch.cuda.synchronize()
            runs.append((att.flash_attention.launches,
                         att.flash_attention_backward.launches,
                         steps.count - n0))
        finally:
            mt.telemetry.set_enabled(True)
    assert runs[0][:2] == runs[1][:2] == runs[2][:2] == (6, 6)
    assert [r[2] for r in runs] == [3, 0, 3]


# ------------------------------------------------- the compile pipeline
MIXED_CASES = [((1568, 2048), -1), ((999, 37), -1), ((2, 7, 7, 64), 3),
               ((3, 37, 5, 7), 1), ((32, 64, 56, 56), 1)]


@pytest.mark.parametrize("residual", [False, True])
@pytest.mark.parametrize("pair", [("bfloat16", "float32"),
                                  ("float32", "bfloat16")])
@pytest.mark.parametrize("shape,axis", MIXED_CASES,
                         ids=["x".join(map(str, s)) + "-ax%d" % a
                              for s, a in MIXED_CASES])
def test_epilogue_mixed_types_equal_plain_version(epi, shape, axis, pair,
                                                  residual):
    """A bf16 x with an f32 y (and the reverse), the bf16 rewrite's
    boundary sites: one launch, bit for bit the plain version."""
    torch, e = epi
    xt, yt = (getattr(torch, d) for d in pair)
    x, s, b, r = _epilogue_inputs(torch, shape, axis, xt, residual,
                                  seed=sum(shape) + 1)
    if r is not None:
        r = r.to(yt)
    before = e.bn_apply_relu_add.launches
    got = e.bn_apply_relu_add(x, s, b, r, axis=axis, out_dtype=yt)
    want = e.bn_apply_relu_add_reference(x, s, b, r, axis=axis,
                                         out_dtype=yt)
    torch.cuda.synchronize()
    assert e.bn_apply_relu_add.launches == before + 1
    assert got.dtype == yt and got.shape == x.shape
    _same_bits(torch, got, want)


def _bn_relu_net(mt, layout):
    s = mt.sym
    h = s.Convolution(s.Variable("data"), kernel=(3, 3), num_filter=16,
                      pad=(1, 1), name="c1", layout=layout)
    h = s.Activation(s.BatchNorm(h, name="bn1", fix_gamma=False,
                                 axis=3 if layout else 1), act_type="relu")
    h = s.Convolution(h, kernel=(3, 3), num_filter=16, pad=(1, 1),
                      name="c2", layout=layout)
    return h


def _bind(mt, np, net, shape, seed=0):
    ex = net.simple_bind(mt.gpu(0), grad_req="null", data=shape)
    rng = np.random.RandomState(seed)
    for n, a in sorted(ex.arg_dict.items()):
        a[:] = rng.uniform(-0.5, 0.5, a.shape).astype(np.float32)
    for n, a in sorted(ex.aux_dict.items()):
        a[:] = (rng.uniform(0.5, 1.5, a.shape) if n.endswith("var")
                else rng.uniform(-0.2, 0.2, a.shape)).astype(np.float32)
    return ex


@pytest.mark.parametrize("layout", [None, "NHWC"])
def test_cast_sandwich_is_one_bf16_epilogue_launch(cuda, layout):
    """Under ``bf16`` the BatchNorm is an f32 island between the rewrite's
    casts (conv -> Cast(f32) -> BN -> ReLU -> Cast(bf16) -> conv): the
    plan runs it as ONE bf16-in, bf16-out epilogue launch, equal to the
    unfused walk of the same rewritten graph; under ``NHWC`` it takes
    the rows path (channels last)."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    from mxtpu_torch.executor import _trace_graph
    from mxtpu_torch.ops import nn as nn_ops
    shape = (4, 12, 12, 3) if layout else (4, 3, 12, 12)
    ex = _bind(mt, np, _bn_relu_net(mt, layout), shape)
    seen = []
    real = nn_ops.bn_apply_relu_add

    def spy(x, scale, shift, residual=None, block_m=1024, axis=-1,
            out_dtype=None):
        seen.append((x.dtype, out_dtype, x.ndim if axis < 0 else axis,
                     x.is_contiguous()))
        return real(x, scale, shift, residual, block_m, axis, out_dtype)

    from mxtpu_torch.ops import epilogue as epi
    nn_ops.bn_apply_relu_add = spy
    try:
        with mt.compile.pipeline_scope(["bf16"]):
            before = epi.bn_apply_relu_add.launches
            got = ex.forward()[0]._data
            torch.cuda.synchronize()
            assert epi.bn_apply_relu_add.launches == before + 1
            sym = ex._xform[(("bf16",), True)][0]
    finally:
        nn_ops.bn_apply_relu_add = real
    assert seen == [(torch.bfloat16, torch.bfloat16,
                     3 if layout else 1, True)]
    run = _trace_graph(sym, False, fuse=False)
    args = {n: a._data for n, a in ex.arg_dict.items()}
    aux = {n: a._data for n, a in ex.aux_dict.items()}
    with torch.inference_mode():
        want = run(args, aux)[0][0]
    # the fold (x * scale + shift) against BatchNorm's (x - mean) * inv
    # * g + beta, then one bf16 rounding on each side
    err = float(((got.float() - want.float()).abs()
                 / want.float().abs().clamp(min=1)).max())
    assert err <= 2e-2, err


def test_axis3_batchnorm_relu_takes_the_rows_path(cuda):
    """An NHWC conv run (the ``layout`` rewrite's form) is dense
    channels-last, so its axis=3 BatchNorm -> ReLU reaches the kernel as
    (N*H*W, C) rows: inner == 1, no plane walk, equal to the plain
    epilogue bit for bit."""
    torch, _ = cuda
    import numpy as np
    import mxtpu_torch as mt
    from mxtpu_torch.ops import epilogue as epi
    from mxtpu_torch.ops import nn as nn_ops
    ex = _bind(mt, np, _bn_relu_net(mt, "NHWC"), (4, 12, 12, 3))
    seen = []
    real = epi._layout

    def spy(shape, axis):
        seen.append(real(shape, axis))
        return real(shape, axis)

    epi._layout = spy
    before = epi.bn_apply_relu_add.launches
    try:
        ex.forward()
        torch.cuda.synchronize()
    finally:
        epi._layout = real
    assert epi.bn_apply_relu_add.launches == before + 1
    assert seen == [(4 * 12 * 12, 16, 1)]
    del nn_ops


def test_bf16_lm_step_launches_the_bf16_flash_pair(cuda):
    """A 2-layer LM through ``Module.fit`` under ``bf16``: FlashAttention
    is bf16-safe (it follows the bf16 projections), so every step
    launches the bf16 flash forward and backward, one each a layer, and
    the loss is finite and near the f32 fit's."""
    torch, att = cuda
    import logging
    import numpy as np
    import mxtpu_torch as mt
    b, t, vocab, layers, steps = 2, 64, 97, 2, 3
    net = mt.models.transformer.get_symbol(vocab, t, num_layers=layers,
                                           num_heads=2, d_model=128)
    rng = np.random.RandomState(0)
    x = rng.randint(0, vocab, (b, t)).astype(np.float32)
    y = np.roll(x, -1, axis=1).reshape(-1)
    dtypes = []
    real = att._launch

    def spy(kernel, q, *a, **k):
        dtypes.append(q.dtype)
        return real(kernel, q, *a, **k)

    losses = {}
    for cfg in ((), ("bf16",)):
        np.random.seed(1)
        mod = mt.mod.Module(net, context=mt.gpu(0),
                            logger=logging.getLogger("quiet"))
        mod.bind([("data", (b, t))], [("softmax_label", (b * t,))])
        mod.init_params(mt.init.Xavier())
        mod.init_optimizer(optimizer="adam")
        f0, b0 = att.flash_attention.launches, \
            att.flash_attention_backward.launches
        att._launch = spy
        with mt.compile.pipeline_scope(cfg):
            mod.init_optimizer(optimizer="adam", force_init=True)
            try:
                for _ in range(steps):
                    batch = mt.io.DataBatch(
                        [mt.nd.array(x, ctx=mt.gpu(0))],
                        [mt.nd.array(y, ctx=mt.gpu(0))])
                    mod.forward_backward(batch)
                    mod.update()
                out = mod.get_outputs()[0].asnumpy()
            finally:
                att._launch = real
        torch.cuda.synchronize()
        assert att.flash_attention.launches - f0 == layers * steps
        assert att.flash_attention_backward.launches - b0 == layers * steps
        losses[cfg] = -np.log(out[np.arange(b * t), y.astype(int)]).mean()
        if cfg:
            assert mod._fused.pipeline_report.applied == ["bf16"]
            assert set(dtypes) == {torch.bfloat16}, dtypes
        dtypes.clear()
    assert np.isfinite(losses[("bf16",)])
    assert abs(losses[("bf16",)] - losses[()]) <= 0.05 * losses[()]


@pytest.mark.parametrize("name,params", [
    ("sgd", {}), ("sgd", {"momentum": 0.9, "clip_gradient": 0.5}),
    ("adam", {"wd": 1e-3})])
def test_foreach_update_is_the_single_tensor_chain_bit_for_bit(cuda, name,
                                                              params):
    """The fused step's SGD and Adam update lists of card tensors in
    foreach calls; each parameter and its state round as the optimizer's
    single-tensor update functions (the Updater's chain) round it, bit
    for bit, over shapes that split and do not split the foreach
    kernels' chunks."""
    torch, _att = cuda
    import mxtpu_torch as mt
    from mxtpu_torch import optimizer as topt
    from mxtpu_torch.module import fused
    o = mt.optimizer.create(name, rescale_grad=0.25, **params)
    init, apply, _ = fused._RULES[type(o).__name__](o)
    gen = torch.Generator(device="cuda").manual_seed(0)
    shapes = [(3,), (64, 3, 7, 7), (1000, 2048), (65537,), (1, 1)]
    ws = [torch.randn(s, device="cuda", generator=gen) for s in shapes]
    gs = [4 * torch.randn(s, device="cuda", generator=gen) for s in shapes]
    lrs = [0.1 * (i + 1) for i in range(len(shapes))]
    wds = [1e-4 * i for i in range(len(shapes))]
    mine = [w.clone() for w in ws]
    theirs = [w.clone() for w in ws]
    s_mine = [init(w) for w in ws]
    s_theirs = [init(w) for w in ws]
    clip = o.clip_gradient or -1.0
    mom = float(getattr(o, "momentum", 0.0) or 0.0)
    for _ in range(3):
        fused._over_lists(apply)(mine, gs, s_mine, lrs, wds)
        for w, g, s, lr, wd in zip(theirs, gs, s_theirs, lrs, wds):
            if name == "adam":
                topt.adam_update_(w, g, s[0], s[1], lr, wd, o.rescale_grad,
                                  clip, o.beta1, o.beta2, o.epsilon)
            elif mom:
                topt.sgd_mom_update_(w, g, s, lr, wd, o.rescale_grad, clip,
                                     mom)
            else:
                topt.sgd_update_(w, g, lr, wd, o.rescale_grad, clip)
    torch.cuda.synchronize()
    for a, b in zip(mine, theirs):
        assert torch.equal(a, b)
    for a, b in zip(s_mine, s_theirs):
        for x, y in zip(a if isinstance(a, tuple) else (a,),
                        b if isinstance(b, tuple) else (b,)):
            assert (x is None and y is None) or torch.equal(x, y)


def _health_mlp(mt, seed=0):
    """The mlp on gpu(0) with the fused step armed and its health rows."""
    import numpy as np
    sym = mt.models.get_mlp(10)
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (32, 784))],
             label_shapes=[("softmax_label", (32,))])
    np.random.seed(seed)
    mod.init_params(mt.init.Xavier())
    mod.init_optimizer(optimizer="adam",
                       optimizer_params={"learning_rate": 1e-3})
    rng = np.random.RandomState(seed)
    batch = mt.io.DataBatch(
        [mt.nd.array(rng.rand(32, 784).astype("float32"), ctx=mt.cpu())],
        [mt.nd.array(rng.randint(0, 10, 32).astype("float32"),
                     ctx=mt.cpu())])
    return mod, batch


def test_health_rows_on_a_cuda_fit_against_float64(cuda):
    """fit(health=True) on gpu(0): each class's four sums of the last
    step against float64 sums of its gradients and weights (within 1e-5
    relative: f32 tree sums over <= 1e5 elements), its max-abs exact,
    no nonfinite; the accumulator's syncs equal a health-off fit's."""
    torch, _att = cuda
    import numpy as np
    import mxtpu_torch as mt
    syncs = {}
    for health in (False, True):
        mod, batch = _health_mlp(mt)
        it = mt.io.NDArrayIter(batch.data[0].asnumpy().repeat(4, 0),
                               batch.label[0].asnumpy().repeat(4, 0), 32)
        seen = []
        mod.fit(it, num_epoch=1, metric_sync=2, health=health,
                batch_end_callback=lambda p: seen.append(
                    p.eval_metric._device_accum.syncs))
        syncs[health] = seen[-1]
    assert syncs[True] == syncs[False] > 0
    f = mod._fused
    olds = {n: f._targets[0][n].double().clone() for n in f._h["names"]}
    mod.forward_backward(batch)
    mod.update()
    rows = f.last_health
    i = 0
    for c, (_lbl, members) in enumerate(f._health_classes):
        g2 = w2 = u2 = 0.0
        gm = 0.0
        for n in members:
            g, w = f._sums[0][n].double(), f._targets[0][n].double()
            g2 += float((g * g).sum())
            w2 += float((w * w).sum())
            u2 += float(((w - olds[n]) ** 2).sum())
            gm = max(gm, float(g.abs().max()))
            i += 1
        got = rows["sums"][c].double().cpu().numpy()
        np.testing.assert_allclose(got[:3], [g2, w2, u2], rtol=1e-5)
        assert got[3] == 0 and float(rows["max"][c]) == gm


@pytest.mark.parametrize("name,params", [
    ("sgd", {"momentum": 0.9, "wd": 1e-4}), ("adam", {"wd": 1e-4})])
def test_foreach_update_with_health_armed_is_the_chain_bit_for_bit(
        cuda, name, params):
    """With the health rows armed, the fused step's update keeps its ops
    and their order: a module's weights after three steps equal, bit for
    bit, the same module's with health off."""
    torch, _att = cuda
    import mxtpu_torch as mt
    out = []
    for armed in (False, True):
        mod, batch = _health_mlp(mt)
        mod.init_optimizer(optimizer=name, optimizer_params=dict(
            params, learning_rate=0.01), force_init=True)
        if armed:
            mod._fused.arm_health()
        for _ in range(3):
            mod.forward_backward(batch)
            mod.update()
        torch.cuda.synchronize()
        out.append({k: v._data.clone()
                    for k, v in mod.get_params()[0].items()})
        assert (mod._fused.last_health is not None) == armed
    for k in out[0]:
        assert torch.equal(out[0][k], out[1][k]), k


def test_reconcile_drift_after_a_step_inside_its_slack(cuda):
    """At a quiescent point after a step (synchronized, collected, cuBLAS
    workspaces released) the allocator's requested bytes on gpu(0) exceed
    the ledger's by exactly what the step left untracked: its health
    rows awaiting the cadence ((C, 4) + (C,) f32; a fit's health session
    consumes them each step)."""
    torch, _att = cuda
    import gc
    import mxtpu_torch as mt

    def quiescent():
        torch.cuda.synchronize()
        gc.collect()
        torch._C._cuda_clearCublasWorkspaces()
        return mt.diagnostics.reconcile()
    mod, batch = _health_mlp(mt)
    mod._fused.arm_health()
    before = quiescent()["by_ctx"]["gpu(0)"]["drift_bytes"]
    mod.forward_backward(batch)
    mod.update()
    after = quiescent()
    assert after["allocator"] == "cuda"
    card = after["by_ctx"]["gpu(0)"]
    rows = mod._fused.last_health
    pending = sum(t.numel() * t.element_size() for t in rows.values())
    assert card["ledger_bytes"] > 0
    assert card["drift_bytes"] - before == pending, (card, pending)


def test_watchdog_fires_on_a_cuda_event_wait_held_by_latency(cuda):
    """A latency injected inside the pacer's registered wait on a CUDA
    event, past the watchdog's deadline: one postmortem naming
    device_wait, with the flight ring, the engine state and the ledger."""
    torch, _att = cuda
    import mxtpu_torch as mt
    diag = mt.diagnostics
    wd = diag.Watchdog(interval=0.02, wait_stall_s=0.1,
                       engine_probe=lambda: (0, 0))
    pacer = mt.module.base_module._Pacer(1, torch.device("cuda"))
    fired = []
    wd._fire = lambda reason: fired.append(diag.postmortem(
        "watchdog: %s" % reason, source="watchdog"))
    wd.start()
    try:
        x = torch.randn(512, 512, device="cuda")
        with mt.faults.scope("executor.device_wait:latency_ms=600,times=1"):
            for _ in range(3):
                x = x @ x
                x = x / x.norm()
                pacer.step_done()
    finally:
        wd.stop()
    assert len(fired) == 1
    pm = fired[0]
    assert "device_wait" in pm["reason"] and pm["source"] == "watchdog"
    assert {"flight", "engine", "ledger"} <= set(pm)


# ----------------------------------------------------------- A.11, C.22
def _overflow_fit(mt, ctx, opt, knob):
    """The mlp fit with ``knob`` at 1e39 (past f32) on ``ctx``: its
    weights and health anomalies."""
    import numpy as np
    rng = np.random.RandomState(7)
    x = rng.rand(128, 784).astype("float32")
    y = rng.randint(0, 10, 128).astype("float32")
    sym = mt.models.get_mlp(10)
    arg_shapes, _, _ = sym.infer_shape(data=(64, 784),
                                       softmax_label=(64,))
    wr = np.random.RandomState(3)
    w = {n: (wr.randn(*s) * 0.05).astype("float32")
         for n, s in zip(sym.list_arguments(), arg_shapes)
         if n not in ("data", "softmax_label")}
    params = {"learning_rate": 0.05, knob: 1e39}
    if opt == "sgd":
        params["momentum"] = 0.9
    mod = mt.mod.Module(sym, context=ctx)
    mod.fit(mt.io.NDArrayIter(x, y, batch_size=64), num_epoch=1,
            optimizer=opt, optimizer_params=params,
            arg_params={k: mt.nd.array(v, ctx=mt.cpu())
                        for k, v in w.items()},
            metric_sync=1, health=True)
    return ({k: v.asnumpy() for k, v in mod.get_params()[0].items()},
            mt.obs.health.panel()["anomalies"])


@pytest.mark.parametrize("opt", ["sgd", "adam"])
@pytest.mark.parametrize("knob", ["learning_rate", "wd", "rescale_grad"])
def test_hyperparameter_past_f32_fits_on_the_card(cuda, opt, knob):
    """C.22: an lr, wd or rescale_grad of 1e39 fits on gpu(0) with no
    error (the fused update rounds the scalar to f32 on the host, inf,
    before the foreach call), nonfinite where the CPU fit is, with the
    CPU fit's health findings."""
    import numpy as np
    import mxtpu_torch as mt
    gw, gfind = _overflow_fit(mt, mt.gpu(0), opt, knob)
    cw, cfind = _overflow_fit(mt, mt.cpu(), opt, knob)
    assert gfind == cfind and "divergence" in gfind
    for k, a in gw.items():
        assert np.array_equal(np.isfinite(a), np.isfinite(cw[k])), k


def _mlp_fixture(mt):
    from mxtpu_torch.models.serving_fixtures import get_fixture
    return get_fixture("mlp")


def test_continuous_k2_byte_identical_to_a_direct_predictor(cuda):
    """K=2 in flight on gpu(0): 24 clients, every answer bit for bit a
    direct Predictor's on the card at one of the buckets; the answers
    are the batches' own pinned tensors (no later batch writes under
    them: each answer still equals its reference after all 24)."""
    import threading
    import numpy as np
    import mxtpu_torch as mt
    sj, params, shapes = _mlp_fixture(mt)
    buckets = (1, 8)
    refs = {b: mt.Predictor(sj, dict(params), ctx=mt.gpu(0),
                            input_shapes={"data": (b, 784)})
            for b in buckets}

    def direct(x, b):
        refs[b].forward(data=mt.serving.pad_rows(x, b))
        return refs[b].get_outputs()[0][:1]

    results, errors = {}, []
    with mt.serving.ServingSession(sj, params, shapes, buckets=buckets,
                                   max_delay_ms=3, contexts=[mt.gpu(0)],
                                   max_in_flight=2,
                                   version_tag="card-k2") as sess:
        def client(i):
            x = np.random.RandomState(i).rand(1, 784).astype(np.float32)
            try:
                results[i] = (x, sess.predict({"data": x}, timeout=60)[0])
            except Exception as exc:
                errors.append(exc)
        ts = [threading.Thread(target=client, args=(i,)) for i in range(24)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=120)
        assert not errors and len(results) == 24
        assert sess.stats()["batches_dispatched"] >= 3
    for i, (x, out) in results.items():
        assert any(np.array_equal(out, direct(x, b)) for b in buckets), i


def test_padded_arena_scatter_leaves_live_slots(cuda):
    """A scatter with pad rows (the out-of-range index) on CUDA tensors
    raises nothing (no device-side assert) and leaves every live slot
    unchanged; a gather with out-of-range pad indices neither; the CUDA
    context stays usable."""
    torch, _att = cuda
    import numpy as np
    import mxtpu_torch as mt
    specs = [{"name": "h", "shape": (1, 3), "dtype": "float32"}]
    a = mt.serving.SequenceSlotArena(4, specs, ctx=mt.gpu(0))
    rows = np.arange(12, dtype=np.float32).reshape(4, 3)
    a.scatter(np.array([0, 1, 2, 3], np.int32), [rows])
    a.scatter(np.array([4, 2, 4, 4], np.int32),
              [np.full((4, 3), -7, np.float32)])
    got = a.gather(np.array([0, 1, 2, 3, 4, 9], np.int32),
                   np.array([0, 0, 0, 0, 1, 1], np.float32))[0]
    torch.cuda.synchronize()
    got = got.cpu().numpy()
    want = rows.copy()
    want[2] = -7
    np.testing.assert_array_equal(got[:4], want)
    assert not got[4:].any()
    a.close()
    p = mt.serving.PagedArena(2, 2, 4, 2, [{"name": "k", "shape": (3,),
                                            "dtype": "float32"}],
                              ctx=mt.gpu(0))
    s0 = p.allocate()
    p.ensure_tokens(s0, 3)
    flat = [p.flat_index(s0, i) for i in range(3)]
    p.scatter_rows(np.array(flat + [p.pad_flat_index], np.int32),
                   [np.arange(12, dtype=np.float32).reshape(4, 3)])
    view = p.gather_view([s0, None])[0]
    torch.cuda.synchronize()
    np.testing.assert_array_equal(
        view[0].reshape(-1, 3)[:3].cpu().numpy(),
        np.arange(9, dtype=np.float32).reshape(3, 3))
    assert float(torch.ones(1, device="cuda").sum()) == 1.0
    p.close()


def test_paged_nan_gate_on_the_card(cuda):
    """NaN in every block of a card's KV pool: the kv session's tokens on
    gpu(0) are the clean run's."""
    torch, _att = cuda
    import mxtpu_torch as mt
    fx = mt.serving.decode.attn_decode_fixture(seed=0)
    reqs = [([1, 2, 3, 4, 5], 4, 0, 0.0), ([3, 1], 4, 1, 0.5)]

    def run(poison):
        with mt.serving.DecodeSession(
                fx["step_symbol_json"], fx["params"],
                fx["step_example_shapes"], [], buckets=(2,),
                slot_capacity=2, prefill_chunk_tokens=2,
                prefill_buckets=(2,), arena="paged", paged=fx,
                contexts=[mt.gpu(0)], version_tag="card-nan") as sess:
            if poison:
                for t in sess.arena._arrays:
                    t.fill_(float("nan"))
            return [sess.generate(p, max_new_tokens=m, seed=s,
                                  temperature=t, timeout=60)["tokens"]
                    for p, m, s, t in reqs]
    assert run(True) == run(False)


def test_swap_with_batches_in_flight_answers_from_the_old_weights(cuda):
    """Batches already dispatched on the old pool when swap_model flips
    answer from the old weights on gpu(0); the next ones from the new."""
    import threading
    import numpy as np
    import mxtpu_torch as mt
    sj, params_a, shapes = _mlp_fixture(mt)
    params_b = {k: v + np.float32(0.25) for k, v in params_a.items()}
    ref = {t: mt.Predictor(sj, dict(p), ctx=mt.gpu(0),
                           input_shapes={"data": (1, 784)})
           for t, p in (("a", params_a), ("b", params_b))}
    x = np.random.RandomState(0).rand(1, 784).astype(np.float32)

    def direct(t):
        ref[t].forward(data=x)
        return ref[t].get_outputs()[0]

    sess = mt.serving.ServingSession(sj, params_a, shapes, buckets=(1,),
                                     max_delay_ms=1, contexts=[mt.gpu(0)],
                                     max_in_flight=2,
                                     version_tag="card-swap-a")
    try:
        rep = sess.pool.replicas[0]
        real, gate = rep.collect, threading.Event()
        rep.collect = lambda h: (gate.wait(30), real(h))[1]
        old = [sess.predict_async({"data": x}) for _ in range(2)]
        deadline = threading.Event()
        for _ in range(500):
            if sum(sess._inflight_n) == 2:
                break
            deadline.wait(0.01)
        assert sum(sess._inflight_n) == 2
        sess.swap_model(sj, params_b, version_tag="card-swap-b")
        gate.set()
        for f in old:
            assert np.array_equal(f.wait(60)[0], direct("a"))
        assert np.array_equal(sess.predict({"data": x}, timeout=60)[0],
                              direct("b"))
    finally:
        sess.close()


# ---------------------------------------------------------------- elastic
def _elastic_mlp(mt, seed=0, n=192, batch=64):
    """The mlp (784-128-64-10) and ``n`` seeded examples."""
    import numpy as np
    rng = np.random.RandomState(seed)
    x = rng.rand(n, 784).astype(np.float32)
    y = rng.randint(0, 10, n).astype(np.float32)
    return mt.io.NDArrayIter(x, y, batch_size=batch,
                             label_name="softmax_label")


def _elastic_fit(mt, ctx=None, kill_at=None, **kw):
    """The mlp fit on gpu(0) (or ``ctx``) with Adam; ``kill_at`` raises
    RuntimeError from the batch callback after that many steps."""
    import numpy as np
    mod = mt.mod.Module(mt.models.mlp.get_symbol(10),
                        context=ctx or mt.gpu(0))
    np.random.seed(3)
    mt.random.seed(3)
    steps = [0]

    def cb(param):
        steps[0] += 1
        if kill_at is not None and steps[0] >= kill_at:
            raise RuntimeError("killed")
    try:
        mod.fit(_elastic_mlp(mt), num_epoch=2, optimizer="adam",
                optimizer_params={"learning_rate": 0.003},
                initializer=mt.init.Xavier(), batch_end_callback=cb, **kw)
    except RuntimeError as exc:
        assert "killed" in str(exc)
    return mod


def _live_arrays(mod):
    """{generation key: cpu tensor} of a fused module's live state."""
    from mxtpu_torch.module.fused import state_leaves
    arg, aux = mod.get_params()
    out = {"arg:%s" % k: v._data for k, v in arg.items()}
    out.update({"aux:%s" % k: v._data for k, v in aux.items()})
    for n, st in mod._fused.opt_state[0].items():
        for i, leaf in enumerate(state_leaves(st)):
            out["opt:%s/%d" % (n, i)] = leaf.cpu()
    return out


def test_elastic_capture_makes_no_host_sync(cuda, tmp_path):
    """The capture on the training thread (clones, the copy to pinned
    memory, the manifest) makes no host sync: it runs under torch's
    sync debug mode set to raise on one."""
    torch, _ = cuda
    import mxtpu_torch as mt
    mod = _elastic_fit(mt)
    cursor = {"epoch": 1, "nbatch": 2, "global_step": 6,
              "epoch_boundary": False}
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        arrays, manifest, ready = mt.elastic.capture_module(mod, cursor)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert ready and manifest["opt_format"] == "leaves"
    assert all(v.is_pinned() for k, v in arrays.items()
               if k.startswith(("arg:", "aux:", "opt:")))


def test_elastic_generation_reloads_bit_for_bit_on_the_card(cuda, tmp_path):
    """A generation written by a fit on gpu(0) holds the live params,
    Adam's moments and counters at the kill bit for bit, and a resumed
    fit on the card ends bit for bit the uninterrupted one."""
    torch, _ = cuda
    import mxtpu_torch as mt
    whole = _elastic_fit(mt)
    prefix = str(tmp_path / "ck")
    cfg = mt.elastic.ElasticConfig(prefix, every_n_steps=1, sync=True)
    killed = _elastic_fit(mt, kill_at=4, elastic=cfg)
    snap = mt.elastic.snapshot
    man = snap.latest_manifest(prefix)
    got = snap.load_arrays(man)
    assert man["cursor"]["global_step"] == 4
    assert man["optimizer"]["num_update"] == killed._optimizer.num_update
    for k, v in _live_arrays(killed).items():
        assert torch.equal(torch.from_numpy(got[k]), v), k
    resumed = _elastic_fit(mt, resume=prefix)
    for a, b in zip(whole.get_params(), resumed.get_params()):
        for k in a:
            assert torch.equal(a[k]._data, b[k]._data), k


def test_elastic_clones_are_independent_of_the_next_step(cuda):
    """The capture's clones on the card and its pinned host copies keep
    the values of the step they were taken after, while the next step
    updates the weights and moments in place."""
    torch, _ = cuda
    import mxtpu_torch as mt
    from mxtpu_torch.module.fused import state_leaves
    mod = _elastic_fit(mt)
    fused = mod._fused
    before = {k: v.clone() for k, v in _live_arrays(mod).items()}
    p, _a, o, ready = fused.export_host_state()
    dev_p, _da, dev_o = fused.export_device_state()
    it = _elastic_mlp(mt)
    mod.forward_backward(next(it))
    mod.update()
    for ev in ready:
        ev.synchronize()
    after = _live_arrays(mod)
    moved = 0
    for n, v in p.items():
        assert torch.equal(v, before["arg:%s" % n]), n
        assert torch.equal(dev_p[n].cpu(), before["arg:%s" % n]), n
        moved += not torch.equal(after["arg:%s" % n], before["arg:%s" % n])
    for n, st in o[0].items():
        for i, leaf in enumerate(state_leaves(st)):
            assert torch.equal(leaf, before["opt:%s/%d" % (n, i)]), n
        for i, leaf in enumerate(state_leaves(dev_o[0][n])):
            assert torch.equal(leaf.cpu(), before["opt:%s/%d" % (n, i)]), n
    assert moved == len(p)


def _odd_net(mt):
    """fc1 (128 rows, kept by rows over two cards) and fc2 (5 rows,
    which no 2-way split divides: the plan keeps it whole)."""
    s = mt.sym
    h = s.Activation(s.FullyConnected(s.Variable("data"), num_hidden=128,
                                      name="fc1"), act_type="relu")
    return s.SoftmaxOutput(s.FullyConnected(h, num_hidden=5, name="fc2"),
                           name="softmax")


def _odd_fit(mt, mesh, kill_at=None, **kw):
    import numpy as np
    rng = np.random.RandomState(0)
    x = rng.rand(192, 784).astype(np.float32)
    y = rng.randint(0, 5, 192).astype(np.float32)
    mod = mt.mod.Module(_odd_net(mt), context=mt.gpu(0))
    np.random.seed(3)
    steps = [0]

    def cb(param):
        steps[0] += 1
        if kill_at is not None and steps[0] >= kill_at:
            raise RuntimeError("killed")
    try:
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=64), num_epoch=2,
                optimizer="adam", optimizer_params={"learning_rate": 0.003},
                initializer=mt.init.Xavier(), batch_end_callback=cb,
                mesh=mesh, **kw)
    except RuntimeError as exc:
        assert "killed" in str(exc)
    return mod


def test_elastic_padded_sharded_plan_leaves_round_trip(cuda, tmp_path):
    """A plan over two cards that keeps fc1's Adam state by rows and
    fc2's 5 rows whole (no 2-way split divides them): the generation
    holds each card's row block and the whole leaves bit for bit, the
    async ``.states`` manifest round-trips into the plan bit for bit,
    and the resumed fit ends bit for bit the uninterrupted one."""
    torch, _ = cuda
    _gpus(torch, 2)
    import mxtpu_torch as mt
    mesh = mt.sharding.MeshContext.create(2, devices=[mt.gpu(0), mt.gpu(1)])
    whole = _odd_fit(mt, mesh)
    prefix = str(tmp_path / "ck")
    cfg = mt.elastic.ElasticConfig(prefix, every_n_steps=1, sync=True)
    mod = _odd_fit(mt, mesh, kill_at=3, elastic=cfg)
    fused = mod._fused
    assert fused.sharded_names == ["fc1_weight"]
    man = mt.elastic.latest_manifest(prefix)
    entries = man["opt_entries"]
    assert len(entries["fc1_weight"]["shards"]["0"]["pieces"]) == 2
    assert "shards" not in entries["fc2_weight"]
    arrays = mt.elastic.load_arrays(man)
    for r in (0, 1):
        for i in (0, 1):
            assert torch.equal(torch.from_numpy(
                arrays["opt:fc1_weight/%d#%d" % (i, r)]),
                fused.opt_state[r]["fc1_weight"][i].cpu())
            assert torch.equal(torch.from_numpy(
                arrays["opt:fc2_weight/%d" % i]),
                fused.opt_state[r]["fc2_weight"][i].cpu())
    fname = str(tmp_path / "mesh.states")
    mod.save_optimizer_states(fname, async_write=True)
    mt.model.wait_checkpoints()
    before = [{k: tuple(x.clone() for x in v) for k, v in st.items()}
              for st in fused.opt_state]
    for st in fused.opt_state:
        for v in st.values():
            for x in v:
                x.zero_()
    mod.load_optimizer_states(fname)
    for st, old in zip(fused.opt_state, before):
        for k in old:
            for x, y in zip(st[k], old[k]):
                assert torch.equal(x, y), k
    resumed = _odd_fit(mt, mesh, resume=prefix)
    for a, b in zip(whole.get_params(), resumed.get_params()):
        for k in a:
            assert torch.equal(a[k]._data, b[k]._data), k


def test_elastic_sigterm_inside_supervisor_run_restores_the_handler(
        cuda, tmp_path):
    """SIGTERM inside ``Supervisor.run`` on the card: the fit flushes a
    final generation, ``Preempted`` propagates, and the SIGTERM handler
    after ``run`` is the one before it."""
    import os
    import signal
    torch, _ = cuda
    import mxtpu_torch as mt
    prefix = str(tmp_path / "ck")
    before = signal.getsignal(signal.SIGTERM)
    sup = mt.elastic.Supervisor(retries=0)
    cfg = mt.elastic.ElasticConfig(prefix, supervisor=sup)

    def fit_fn(resume):
        mod = mt.mod.Module(mt.models.mlp.get_symbol(10),
                            context=mt.gpu(0))

        def cb(param):
            if param.nbatch == 1:
                os.kill(os.getpid(), signal.SIGTERM)
        mod.fit(_elastic_mlp(mt), num_epoch=2, optimizer="sgd",
                initializer=mt.init.Xavier(), batch_end_callback=cb,
                elastic=cfg, resume=resume)

    with pytest.raises(mt.elastic.Preempted):
        sup.run(fit_fn)
    assert signal.getsignal(signal.SIGTERM) is before
    man = mt.elastic.latest_manifest(prefix)
    assert man["cursor"]["global_step"] == 3
