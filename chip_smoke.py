"""Drive the PyTorch/CUDA port's serving and training paths on one
NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--seed N] [--profile]
                          [--phases kernels,epilogue,...]
                          [--parent CSRC [--parent CSRC ...]]

Phases (any failure raises and exits non-zero):

1. Device: require CUDA; print the card's name and power limit.
2. Build every hand-written kernel of ``mxtpu_torch/csrc`` with nvcc
   (one process per source, started together) and print the seconds;
   print each kernel instance's registers and spills (the LM's flash
   instances must not spill: the forward's float32 D=64 with and without
   lse, the backward's dK/dV and dQ kernels at D=64 in float32 and
   bfloat16) and, where the toolkit has cuobjdump, count each flash
   library's tensor-core (HMMA) instructions (none is a failure). With
   ``--parent CSRC`` (the ``csrc`` directory of another tree, such as the
   parent commit or a variant of this one; repeatable) also build that
   tree's flash sources and print the same figures for them.
3. Flash kernel vs plain: the flash-attention kernel against its plain
   PyTorch version on the card, at the LM path's shapes and at edge
   cases, in float32 (max abs err <= 2e-4) and bfloat16 (<= 2e-2); then,
   at the served shape for B = 1 and 4 in both types, CUDA-event times of
   the kernel, the plain version and the library call that computes the
   same function (timed as a yardstick only; the port never calls it),
   beside the least time the card could take (bound_ms): float32 counted
   as three TF32 tensor-core passes, the route the kernel takes.
3b. Epilogue kernel vs plain: the BN-apply+ReLU(+residual) kernel
   against its plain version at ResNet-50's bucket-32 sites, channel-minor
   and NCHW, float32 and bfloat16, with and without the residual, a
   ragged M, C = 37 and planted NaN/inf: max abs err must be 0 and the
   NaN positions equal. Then CUDA-event times beside bound_ms (bytes).
   No one PyTorch call computes relu(x*s+b)[+r], so library_ms is null.
3c. Flash backward kernel vs plain: the backward (dq, dk, dv) against
   its plain version on the same q, k, v, o, dO and lse, and the forward
   kernel's lse against the plain lse, at the LM's shapes and at edge
   cases (T, S in {1, 15, 16, 17, 63, 64, 65, 127, 129}, around the 16-row
   warp tiles and the 64-row block tiles; T != S under the causal mask;
   S = 0; D 32/64/128; NaN stored past every tensor's end; storage
   offsets that are not 16-byte aligned), float32 (error / max(1,
   |plain|) <= 1e-4) and bfloat16 (<= 2e-2); a second call must give
   bit-identical dq, dk and dv. Then CUDA-event times at the
   LM's shape beside the plain version, the bound at the card's peak for
   each type (f32 as three TF32 passes, bf16 on the tensor cores; the
   figure of the kernel's own 7-product route printed beside it), SDPA's
   backward alone as the library yardstick, and the forward with and
   without lse. Last, the float32 kernel at B=1, H=1 and the LM's T, S
   and D beside a CPU emulation of its arithmetic, with each MMA's f32
   sum rounded to nearest and truncated as the tensor cores truncate it:
   the errors show which model the card follows (printed, not gated).
   With ``--parent``,
   phases 3 and 3c also time each other tree's kernels on the same
   inputs, in turns: parent, this, this, parent.
4. LM serving: the transformer LM at GPT-2-small widths with seeded
   random weights, served by ``ServingSession`` on gpu(0) with buckets
   (1, 4): 8 requests of 1024 tokens from 4 client threads. Checks that
   every probability row is finite and sums to 1, that the flash kernel
   ran exactly once per layer per dispatched batch, and that one answer
   matches a ``Predictor`` on cpu() (the plain versions).
5. ResNet-50 serving: pre-activation ResNet-50 v2 at 224x224 with seeded
   random weights and BN statistics, served with buckets (1, 8, 32): 64
   requests from 8 client threads. Checks 50 fused BatchNorm->ReLU sites,
   ``launches == 50 x dispatched batches`` for the epilogue kernel,
   finite rows summing to 1, and one answer against a cpu() Predictor.
6. LM training: the transformer LM at GPT-2-small widths and depth
   trained through ``Module.fit`` on gpu(0) with Adam, from seeded Xavier
   weights, on one seeded batch (B=4, T=1024) repeated 8 times. Checks a
   finite cross-entropy that falls, and exactly one flash forward and one
   flash backward launch per layer per step; prints step ms, tokens/s,
   peak device memory, one step with the fused update against one
   through the Updater in turns, and
   (``--profile``) one step's device time by kernel. Then one SGD step of
   a 2-layer model at full width, B=1, on gpu(0) and on a cpu() Module
   from the same weights, each held to the exact step of a float64
   gradient: the GPU's outputs within TRAIN_OUT_RTOL of the CPU's and its
   distance from the exact step no more than TRAIN_CPU_FACTOR times the
   CPU f32 step's own; a GPU step with TF32 GEMMs must fail both gates.
7. ResNet-50 training through ``Module.fit`` (``resnet_training``;
   see ``phase_resnet_training``).
8. Gluon ResNet-50 training (``gluon``): the zoo's ``resnet50_v2`` at
   224x224, full depth and width, f32 with TF32 off, Xavier weights from
   a numpy seed on gpu(0) (deferred shapes resolved by the first batch),
   ``DataLoader(ArrayDataset(images, labels), batch_size=256)`` over phase
   7's 512 seeded images, ``SoftmaxCrossEntropyLoss`` and
   ``Trainer(..., "sgd", lr 0.1, momentum 0.9).step(256)``: 8 hybridized
   steps of ``autograd.record()`` / ``backward()`` / ``step``, 4 with
   ``hybridize(False)``, 4 hybridized again with ``num_workers=2``.
   Gates: a finite loss that falls, moving statistics that moved,
   ``save_params`` reloaded by a fresh net bit for bit, the hybridized
   evaluation forward (B=256, outside ``record()``) launching the
   epilogue at its 50 fused sites and within 1e-4 of the plain epilogue,
   and the narrow ResNetV2's one SGD step on gpu(0) hybridized and
   imperative held to the float64 step as phase 7 holds resnet-8 (a TF32
   control must fail). Prints step ms (host clock, each step ending in a
   device sync; mean after 2 warm-up steps) and the DataLoader's share of
   it, images/s, MFU, peak memory, and phase 7's Module step beside it.
9. Prints the kernels' JSON line, then the device line last.
"""
from __future__ import annotations

import argparse
import json
import os
import re
import shutil
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# the operations/s of each type the kernels compute in: f32 on the CUDA
# cores, bf16 and TF32 on the tensor cores
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}
PEAK_TF32_OPS_PER_S = 495e12
# the flash kernel computes an f32 product as three TF32 products
# (3xTF32: big*small + small*big + big*big)
TF32_PASSES = 3
# the flash instances of the LM's paths, float32 D=64: without lse
# (served) and with it (trained)
FLASH_PATH_INSTANCES = ("flash_fwd_kernel<float, 64, false>",
                        "flash_fwd_kernel<float, 64, true>")
# the backward's instances on the LM's shape (D=64), both kernels, both
# types
FLASH_BWD_PATH_INSTANCES = tuple(
    "flash_bwd_%s_kernel<%s, 64>" % (kern, typ)
    for kern in ("dkdv", "dq") for typ in ("float", "bf16"))
# products of 2*D flops for each live pair in the backward: the five the
# gradient needs (S, dP, dV, dK, dQ), and the seven the kernels do (S and
# dP again in the dQ kernel, so that no output needs atomics)
BWD_PRODUCTS = 5
BWD_ROUTE_PRODUCTS = 7

LM = dict(vocab_size=50257, seq_len=1024, num_layers=12, num_heads=12,
          d_model=768, d_ff=3072)  # GPT-2 small (Radford et al. 2019)
BUCKETS = (1, 4)
# LM training (phase 6): Adam on one seeded batch repeated `steps` times
TRAIN = dict(batch=4, steps=8, warmup=2, lr=5e-4)
# the 2-layer GPU vs CPU step: SGD lr, output tolerance (probabilities,
# relative, element by element), and how far from the exact float64 step
# the GPU's f32 step may be, as a multiple of the CPU f32 step's distance.
# On an H100 the f32 GPU step reads 6.7e-6 and 0.34, a step with TF32
# GEMMs 6.7e-4 and 3.4: each gate sits between the two
TRAIN_CPU_LR = 0.01
TRAIN_OUT_RTOL = 5e-5
TRAIN_CPU_FACTOR = 1.0
N_REQUESTS = 8
N_CLIENTS = 4
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}
# backward: max |kernel - plain| / max(1, max |plain|) over dq, dk, dv.
# f32: both sum in f32, in other orders; bf16: both round their f32 sums
# to bf16 (2^-8 relative), so one bf16 ulp of the largest value
BWD_TOL = {torch.float32: 1e-4, torch.bfloat16: 2e-2}
# forward lse, absolute: ex2.approx and log2f against torch's exp/log
LSE_TOL = {torch.float32: 1e-4, torch.bfloat16: 1e-3}

# pre-activation ResNet-50 v2 (He et al. 2016), mxtpu/models/resnet.py
RESNET = dict(num_classes=1000, num_layers=50, image_shape=(3, 224, 224))
RESNET_SITES = 50  # bn0 + 3 per bottleneck unit x 16 + bn1
RESNET_BUCKETS = (1, 8, 32)
RESNET_REQUESTS = 64
RESNET_CLIENTS = 8
# (shape, channel axis): ResNet-50's bucket-32 extremes, bn0 (112x112x64)
# and bn1 (7x7x2048), channel-minor as the TPU kernel takes them and NCHW
# as the served graph hands them over; a ragged M; C = 37
EPILOGUE_CASES = [((401408, 64), -1), ((1568, 2048), -1),
                  ((32, 64, 112, 112), 1), ((32, 2048, 7, 7), 1),
                  ((1000, 72), -1), ((999, 37), -1)]
EPILOGUE_MAIN = ((32, 64, 112, 112), 1)  # bn0 at bucket 32, as served
# ResNet-50 v2 trained through Module.fit (phase 7), as mxtpu's bench.py
# configures its headline run (bench.py:535-559): B=256, Xavier gaussian
# "in" magnitude 2, SGD lr 0.1, momentum 0.9, rescale 1/B; 512 seeded
# images for 4 epochs (8 steps), prefetched onto the card, a checkpoint
# at each epoch's end
RESNET_TRAIN = dict(batch=256, images=512, epochs=4, warmup=2, lr=0.1,
                    momentum=0.9, copy_steps=3)
# bench.py:23: 3 x (2 x 4.089 GFLOP) a trained image (forward + backward)
RESNET_FLOPS_PER_IMAGE = 3 * 2 * 4.089e9
# the one-step gate of phase 7: resnet-8 at B=32 (mxtpu's tests' size)
RESNET8 = dict(num_classes=10, num_layers=8, image_shape=(3, 28, 28))
RESNET8_BATCH = 32
RESNET8_LR = 0.1
# Gluon's resnet50_v2 trained through autograd.record and Trainer.step
# (phase 8), the loop of examples/gluon/image_classification.py: the same
# 512 images, batch, initializer and SGD as phase 7; 8 hybridized steps
# and 4 imperative with DataLoader(num_workers=0), then 4 hybridized with
# a threaded DataLoader; the one-step gate's net is the zoo's narrowest
# ResNetV2 at resnet-8's size
GLUON_TRAIN = dict(batch=256, hybrid_steps=8, imperative_steps=4,
                   worker_steps=4, num_workers=2, warmup=2, lr=0.1,
                   momentum=0.9)
GLUON_NARROW = dict(layers=[1, 1, 1], channels=[16, 16, 32, 64],
                    classes=10, thumbnail=True)
PHASES = ("kernels", "epilogue", "backward", "serving", "resnet", "training",
          "resnet_training", "gluon")


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of fn() over ``iters`` back-to-back calls. The
    calls queue behind a spin kernel that outlasts their host-side cost,
    so the card runs them back to back even where one call takes longer
    on the host than on the card (a ~20 us kernel behind its Python
    wrapper)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    fn()
    torch.cuda.synchronize()
    call_s = time.perf_counter() - t0  # host and device, an upper bound
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    # ~2e9 cycles a second at the card's top clock: spin at least as long
    # as twice the host time of the calls, at most ~1 s
    torch.cuda._sleep(int(min(2.0 * call_s * iters, 1.0) * 2e9))
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_pairs(t, s, causal):
    """Live (row, key) pairs of one head: every pair, or under the causal
    mask (col <= row, top-left) min(row + 1, S) keys for each row."""
    if not causal:
        return t * s
    n = min(t, s)
    return n * (n + 1) // 2 + max(t - s, 0) * s


def attention_flops(b, h, t, s, d, causal):
    """Flops of the attention forward: live (row, key) pairs times 4*d
    (q.k and p.v, a multiply and an add each)."""
    return 4.0 * d * attention_pairs(t, s, causal) * b * h


def attention_bound_ms(b, h, t, s, d, causal, dtype):
    """Least time for the attention forward: its operations on the
    tensor cores (f32 as TF32_PASSES TF32 passes at the TF32 peak, bf16 at
    the bf16 peak), or q, k, v read and o written once against the HBM
    rate, whichever is larger."""
    flops = attention_flops(b, h, t, s, d, causal)
    if dtype == torch.float32:
        ops_ms = TF32_PASSES * flops / PEAK_TF32_OPS_PER_S * 1e3
    else:
        ops_ms = flops / PEAK_OPS_PER_S[dtype] * 1e3
    nbytes = (2 * b * h * t * d + 2 * b * h * s * d) * \
        torch.empty((), dtype=dtype).element_size()
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def cuda_core_ms(b, h, t, s, d, causal):
    """The f32 flops against the CUDA cores' f32 peak: the bound of the
    earlier CUDA-core kernel, printed beside the tensor-core bound for
    continuity."""
    return attention_flops(b, h, t, s, d, causal) / \
        PEAK_OPS_PER_S[torch.float32] * 1e3


def ptxas_instances(text):
    """(kernel instance, registers, spill store bytes, spill load bytes)
    of each entry function that one ``nvcc -Xptxas -v`` log reports."""
    rows, name, spill = [], None, (0, 0)
    for line in text.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = _instance_name(m.group(1))
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads",
                      line)
        if m:
            spill = (int(m.group(1)), int(m.group(2)))
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and name:
            rows.append((name, int(m.group(1))) + spill)
            name, spill = None, (0, 0)
    return rows


def _instance_name(sym):
    """'flash_fwd_kernel<float, 64, false>' from a mangled template name
    (the argument forms csrc/ uses: float, bf16, int, bool)."""
    m = re.search(r"([a-z_]+_kernel)I(.*?E)E", sym)
    if not m:
        return sym
    words = {"f": "float", "13__nv_bfloat16": "bf16", "Lb0E": "false",
             "Lb1E": "true"}
    args = re.findall(r"13__nv_bfloat16|Li\d+E|Lb[01]E|f", m.group(2))
    return "%s<%s>" % (m.group(1), ", ".join(words.get(a, a[2:-1])
                                             for a in args))


def sass_hmma(path):
    """HMMA instructions in a library's SASS (cuobjdump -sass), or None
    where the toolkit has no cuobjdump."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "-sass", str(path)], capture_output=True,
                         text=True, check=True, timeout=300)
    return sum("HMMA" in line for line in out.stdout.splitlines())


def check_flash_build(build):
    """The flash instances of the LM's paths do not spill, and each flash
    library's SASS (where the toolkit has cuobjdump) holds tensor-core
    HMMA instructions. Returns {library: HMMA count}."""
    counts = {}
    for lib, names in (("flash_attn_fwd", FLASH_PATH_INSTANCES),
                       ("flash_attn_bwd", FLASH_BWD_PATH_INSTANCES)):
        inst = {row[0]: row for row in
                ptxas_instances(build.build_log[lib]["ptxas"])}
        for name in names:
            row = inst.get(name)
            if row is None:
                # reused from an earlier build of the same source: no log
                log("  %s: %s: no ptxas log (library reused)" % (lib, name))
            elif row[2] or row[3]:
                raise AssertionError("%s spills: %s" % (name, row))
        hmma = sass_hmma(build._target(lib)[1])
        if hmma is None:
            log("  %s: no cuobjdump, SASS not checked" % lib)
            continue
        log("  %s: %d HMMA instructions in the SASS (cuobjdump -sass)"
            % (lib, hmma))
        if hmma == 0:
            raise AssertionError("%s has no HMMA instruction" % lib)
        counts[lib] = hmma
    return counts


class ParentKernels:
    """Another tree's flash sources (``--parent``: its ``csrc``
    directory), built with this tree's nvcc flags into
    ``build/mxtpu_torch/parent<index>`` and bound by ``attention.bind``,
    to time them in turns with this tree's kernels on the same inputs
    through the wrappers' own launch code (``attention._launch``,
    ``_launch_bwd``)."""

    NAMES = ("flash_attn_fwd", "flash_attn_bwd")

    def __init__(self, build, csrc, index=0):
        self.csrc = csrc
        self.dir = build.BUILD_DIR / ("parent%d" % index)
        self.dir.mkdir(parents=True, exist_ok=True)
        self._procs = {}
        for name in self.NAMES:
            out = self.dir / ("lib%s.so" % name)
            self._procs[name] = (build.spawn(
                os.path.join(csrc, name + ".cu"), out), out)
        self.kernels, self.ptxas, self.hmma = {}, {}, {}

    def finish(self, att):
        """Wait for the builds started by __init__, bind the libraries and
        print their registers, spills and HMMA counts."""
        import ctypes
        for name, (proc, out) in self._procs.items():
            text, _ = proc.communicate()
            if proc.returncode != 0:
                raise AssertionError("%s %s does not build:\n%s"
                                     % (self.csrc, name, text))
            self.ptxas[name] = ptxas_instances(text)
            self.hmma[name] = sass_hmma(out)
            self.kernels[name] = att.bind(ctypes.CDLL(str(out)), name)
            for inst, regs, st, ld in self.ptxas[name]:
                log("  parent %s %s: %s: %d registers, %d bytes spill "
                    "stores, %d bytes spill loads" % (self.csrc, name, inst,
                                                      regs, st, ld))
            log("  parent %s %s: %s HMMA instructions" % (self.csrc, name,
                                                          self.hmma[name]))
        return self


def in_turns(parent_fn, this_fn, iters):
    """CUDA-event ms of two versions of one call, in turns: parent, this,
    this, parent. Returns ([parent ms], [this ms])."""
    p1 = cuda_ms(parent_fn, iters)
    t1 = cuda_ms(this_fn, iters)
    t2 = cuda_ms(this_fn, iters)
    p2 = cuda_ms(parent_fn, iters)
    return [p1, p2], [t1, t2]


def phase_kernels(att, gen, parents=()):
    """Flash kernel vs its plain version; returns the timed rows (f32 and
    bf16 at each bucket of the served shape) and the worst error by type.
    With ``parents`` (ParentKernels), each timed row also holds each other
    tree's forward and this tree's, timed in turns on the same inputs."""
    F = torch.nn.functional
    cases = [  # (B, H, T, S, D, causal)
        (1, 12, 1024, 1024, 64, True),   # the served shapes: bucket 1 ...
        (4, 12, 1024, 1024, 64, True),   # ... and bucket 4
        (4, 12, 1024, 1024, 64, False),
        (2, 12, 1000, 1000, 64, True),   # ragged tail
        (2, 12, 256, 1000, 64, True),    # T != S, top-left causal
        (2, 12, 256, 1000, 64, False),
        (2, 8, 512, 512, 128, True),     # D = 128
        (2, 8, 300, 300, 32, False),     # D = 32
    ]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for b, h, t, s, d, causal in cases:
            q = torch.randn(b, h, t, d, device="cuda", generator=gen) \
                .to(dtype)
            k = torch.randn(b, h, s, d, device="cuda", generator=gen) \
                .to(dtype)
            v = torch.randn(b, h, s, d, device="cuda", generator=gen) \
                .to(dtype)
            got = att.flash_attention(q, k, v, causal=causal)
            want = att.flash_attention_reference(q, k, v, causal=causal)
            torch.cuda.synchronize()
            err = (got.float() - want.float()).abs().max().item()
            finite = bool(torch.isfinite(got).all().item())
            log("  flash %-8s B=%d H=%d T=%d S=%d D=%d causal=%d  "
                "max_abs_err=%.3e" % (str(dtype).split(".")[1], b, h, t, s,
                                      d, causal, err))
            if not finite or not err <= TOL[dtype]:
                raise AssertionError(
                    "flash kernel disagrees with its plain version: err %r "
                    "> %r (finite=%s) at %s" % (err, TOL[dtype], finite,
                                                (b, h, t, s, d, causal,
                                                 dtype)))
            worst[dtype] = max(worst.get(dtype, 0.0), err)

    timed = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for b in BUCKETS:
            h, t, d = 12, 1024, 64
            q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                       .to(dtype) for _ in range(3))
            got = att.flash_attention(q, k, v, causal=True)
            want = att.flash_attention_reference(q, k, v, causal=True)
            err = (got.float() - want.float()).abs().max().item()
            if not err <= TOL[dtype]:
                raise AssertionError("flash kernel disagrees at the served "
                                     "shape: %r (%s, B=%d)" % (err, name, b))
            ms = cuda_ms(lambda: att.flash_attention(q, k, v, causal=True),
                         50)
            plain_ms = cuda_ms(
                lambda: att.flash_attention_reference(q, k, v, causal=True),
                10)
            lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
                q, k, v, is_causal=True), 50)
            bound_ms, bound_by = attention_bound_ms(b, h, t, t, d, True,
                                                    dtype)
            row = dict(dtype=name, B=b, max_abs_err=err, ms=ms,
                       plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by)
            extra = ""
            if dtype == torch.float32:
                row["cuda_core_ms"] = cuda_core_ms(b, h, t, t, d, True)
                extra = "; CUDA-core f32 figure %.4f ms" % row["cuda_core_ms"]
            log("  flash %s causal B=%d H=%d T=S=%d D=%d: kernel %.4f ms, "
                "plain %.4f ms, sdpa %.4f ms (kernel/sdpa %.2f), bound %.4f "
                "ms (%s; kernel at %.1f%% of it)%s, err %.3e"
                % (name, b, h, t, d, ms, plain_ms, lib_ms, ms / lib_ms,
                   bound_ms, bound_by, 100.0 * bound_ms / ms, extra, err))
            row["turns"] = []
            for parent in parents:
                this_k = att._kernel()
                pk = parent.kernels["flash_attn_fwd"]
                scale = d ** -0.5
                perr = (att._launch(pk, q, k, v, True, scale).float()
                        - got.float()).abs().max().item()
                p_ms, t_ms = in_turns(
                    lambda: att._launch(pk, q, k, v, True, scale),
                    lambda: att._launch(this_k, q, k, v, True, scale), 50)
                row["turns"].append(dict(parent=parent.csrc, parent_ms=p_ms,
                                         this_ms=t_ms, max_abs_diff=perr))
                log("    in turns with %s (parent, this, this, parent): "
                    "%.4f, %.4f, %.4f, %.4f ms; max abs diff %.3e"
                    % (parent.csrc, p_ms[0], t_ms[0], t_ms[1], p_ms[1], perr))
            timed.append(row)
    return timed, worst


def backward_flops(b, h, t, s, d, causal, products=BWD_PRODUCTS):
    """Flops of the attention backward: ``products`` products of 2*d
    flops for each live pair; by default the five that the gradient needs
    (S, dP, dV, dK, dQ). The kernels do seven (BWD_ROUTE_PRODUCTS)."""
    return products * 2.0 * d * attention_pairs(t, s, causal) * b * h


def _tensor_core_ms(flops, dtype):
    """``flops`` at the card's tensor-core peak for ``dtype``: f32 as
    TF32_PASSES TF32 passes at the TF32 peak, bf16 at the bf16 peak."""
    if dtype == torch.float32:
        return TF32_PASSES * flops / PEAK_TF32_OPS_PER_S * 1e3
    return flops / PEAK_OPS_PER_S[dtype] * 1e3


def backward_bound_ms(b, h, t, s, d, causal, dtype):
    """Least time for the attention backward at the card's peak for its
    type, as the forward's bound counts it: f32 as TF32_PASSES TF32
    passes at the TF32 peak (3xTF32 keeps f32-grade error), bf16 at the
    bf16 tensor-core peak; or q, k, v, o, dO read and dq, dk, dv written
    once plus the f32 lse, against the HBM rate; whichever is larger."""
    ops_ms = _tensor_core_ms(backward_flops(b, h, t, s, d, causal), dtype)
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = (4 * b * h * t * d + 4 * b * h * s * d) * esize + b * h * t * 4
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def backward_route_ms(b, h, t, s, d, causal, dtype):
    """The least time of the kernels' own route: its seven products at
    the type's tensor-core peak (f32 as three TF32 passes), printed beside
    the bound."""
    return _tensor_core_ms(backward_flops(b, h, t, s, d, causal,
                                          BWD_ROUTE_PRODUCTS), dtype)


def abs_err(got, want):
    """max |got - want| in f32 (inf on a NaN)."""
    if got.numel() == 0:
        return 0.0
    g = got.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return (g - want.float()).abs().max().item()


def rel_err(got, want):
    """max |got - want| / max(1, max |want|), in f32 (inf on a NaN)."""
    if got.numel() == 0:
        return 0.0
    g, w = got.float(), want.float()
    if not bool(torch.isfinite(g).all()):
        return float("inf")
    return ((g - w).abs().max() / w.abs().max().clamp(min=1.0)).item()


def tf32_round(x):
    """f32 rounded to TF32 (10 stored mantissa bits): to nearest, ties away
    from zero, as the kernels' tf32_rna rounds (csrc/mma_sm90.cuh)."""
    return ((x.view(torch.int32) + 0x1000) & -0x2000).view(torch.float32)


def emulated_matmul(a, b, passes, acc="rn"):
    """a @ b (f32, on the CPU) as the kernels' mma.sync m16n8k8 forms it:
    TF32 operands, one pass (big*big) or 3xTF32 (small*big, big*small,
    big*big, in that order, with x = big + small), products exact (11
    by 11 bits fit in f32), in steps of 8 along the reduction. After each
    MMA the f32 accumulator is the exact sum of it and the 8 products
    rounded to nearest (``acc="rn"``), or (``"tc"``) that sum as the
    tensor cores form it: each of the 9 addends truncated toward zero to
    2 bits below the f32 ulp of the largest of them, then the sum
    truncated to f32. Phase 3c holds the kernel against both."""
    ab, bb = tf32_round(a), tf32_round(b)
    parts = [(ab, bb)] if passes == 1 else [
        (tf32_round(a - ab), bb), (ab, tf32_round(b - bb)), (ab, bb)]
    out = torch.zeros(a.shape[:-1] + b.shape[-1:], dtype=torch.float32)
    for k0 in range(0, a.shape[-1], 8):
        for x, y in parts:
            x8, y8 = x[..., k0:k0 + 8], y[..., k0:k0 + 8, :]
            if acc == "rn":
                out = (out.double() + x8.double() @ y8.double()).float()
                continue
            terms = x8.unsqueeze(-1) * y8.unsqueeze(-3)
            top = torch.maximum(terms.abs().amax(dim=-2), out.abs())
            # addends in units of the grid 2^(e - 26), truncated: integers
            # below 2^26, whose sum of 9 is exact in int64
            inv = torch.ldexp(torch.ones_like(top), 26 - torch.frexp(top)[1])
            units = terms.mul_(inv.unsqueeze(-2)).trunc_().long().sum(dim=-2)
            units += out.mul(inv).trunc_().long()
            exact = units.double() / inv.double()
            out = exact.float()
            out = torch.where(out.double().abs() > exact.abs(),
                              torch.nextafter(out, torch.zeros_like(out)),
                              out)
    return out


def emulated_backward(q, k, v, out, g, lse, causal, passes, acc="rn"):
    """(dq, dk, dv) with the f32 arithmetic of csrc/flash_attn_bwd.cu on
    the CPU: S = Q K^T and dP = dO V^T by ``emulated_matmul``, P =
    exp(S*scale - lse) and dS = P (dP - delta) in f32, then dV = P^T dO,
    dK = dS^T Q and dQ = dS K by ``emulated_matmul`` (P and dS split like
    any other operand), each accumulated in one register over the whole
    reduction as the kernels accumulate it."""
    t, s, d = q.shape[2], k.shape[2], q.shape[3]
    scale = d ** -0.5
    delta = (g * out).sum(dim=-1, keepdim=True)
    p = torch.exp(emulated_matmul(q, k.transpose(-1, -2), passes, acc)
                  * scale - lse.unsqueeze(-1))
    if causal:
        p = p.masked_fill(torch.arange(s)[None, :] > torch.arange(t)[:, None],
                          0.0)
    ds = p * (emulated_matmul(g, v.transpose(-1, -2), passes, acc) - delta)
    dv = emulated_matmul(p.transpose(-1, -2), g, passes, acc)
    dk = emulated_matmul(ds.transpose(-1, -2), q, passes, acc) * scale
    dq = emulated_matmul(ds, k, passes, acc) * scale
    return dq, dk, dv


def backward_numerics(att, gen, case=(1, 1, 1024, 1024, 64, True)):
    """Where the f32 backward's error comes from: the kernel's dq, dk, dv
    at the LM's T, S and D, and the CPU emulation of its arithmetic
    (``emulated_backward``, 3xTF32) with each MMA's sum rounded to
    nearest and truncated as the tensor cores truncate it, each held
    against the plain version and the kernel (scaled as BWD_TOL scales).
    Returns the errors."""
    b, h, t, s, d, causal = case
    q, k, v, g = (x.cpu() for x in bwd_inputs(b, h, t, s, d, torch.float32,
                                              gen))
    out, lse = att.flash_attention_reference(q, k, v, causal=causal,
                                             return_lse=True)
    want = att.flash_attention_backward_reference(q, k, v, out, g, lse,
                                                  causal=causal)
    got = [x.cpu() for x in att.flash_attention_backward(
        *(x.cuda() for x in (q, k, v, out, g, lse)), causal=causal)]
    model = {acc: emulated_backward(q, k, v, out, g, lse, causal, 3, acc)
             for acc in ("rn", "tc")}

    def err(x, y):
        return max(rel_err(a, w) for a, w in zip(x, y))

    row = dict(case=list(case), kernel_vs_plain=err(got, want),
               rn_model_vs_plain=err(model["rn"], want),
               tc_model_vs_plain=err(model["tc"], want),
               kernel_vs_rn_model=err(got, model["rn"]),
               kernel_vs_tc_model=err(got, model["tc"]))
    log("  f32 backward numerics at B=%d H=%d T=%d S=%d D=%d causal=%d "
        "(scaled): kernel vs plain %.3e; 3xTF32 model vs plain, MMA sums "
        "rounded to nearest %.3e, truncated as the tensor cores do %.3e; "
        "kernel vs the round-to-nearest model %.3e, vs the truncating "
        "model %.3e" % (b, h, t, s, d, causal, row["kernel_vs_plain"],
                        row["rn_model_vs_plain"], row["tc_model_vs_plain"],
                        row["kernel_vs_rn_model"],
                        row["kernel_vs_tc_model"]))
    return row


def bwd_inputs(b, h, t, s, d, dtype, gen, offset=0, nan_tail=0):
    """q, k, v, dO of one backward case. Each is a contiguous view
    ``offset`` elements into a buffer whose other elements (before the
    view and ``nan_tail`` after it) are NaN, which the kernel must never
    read."""
    def make(n):
        numel = b * h * n * d
        buf = torch.full((offset + numel + nan_tail,), float("nan"),
                         device="cuda", dtype=dtype)
        buf[offset:offset + numel] = torch.randn(
            numel, device="cuda", generator=gen).to(dtype)
        return buf[offset:offset + numel].view(b, h, n, d)
    return tuple(make(n) for n in (t, s, s, t))


def check_bwd_case(att, case, dtype, gen, offset=0, nan_tail=0):
    """The backward kernel against its plain version on one case, the
    forward kernel's lse against the plain lse, and a second call bit
    for bit against the first. Returns the scaled error."""
    b, h, t, s, d, causal = case
    name = str(dtype).split(".")[1]
    q, k, v, g = bwd_inputs(b, h, t, s, d, dtype, gen, offset, nan_tail)
    out, lse = att.flash_attention_reference(q, k, v, causal=causal,
                                             return_lse=True)
    if nan_tail:  # the lse too, past its end
        buf = torch.full((lse.numel() + nan_tail,), float("nan"),
                         device="cuda")
        buf[:lse.numel()] = lse.reshape(-1)
        lse = buf[:lse.numel()].view(lse.shape)
    got_o, got_lse = att._flash_cuda(q, k, v, causal, d ** -0.5,
                                     want_lse=True)
    fin = torch.isfinite(lse)
    lse_err = 0.0
    if bool(fin.any()):
        lse_err = (got_lse[fin] - lse[fin]).abs().max().item()
    if not torch.equal(torch.isfinite(got_lse), fin) or \
            not lse_err <= LSE_TOL[dtype]:
        raise AssertionError("flash forward lse disagrees: %r at %s"
                             % (lse_err, (case, name)))
    got = att.flash_attention_backward(q, k, v, out, g, lse, causal=causal)
    again = att.flash_attention_backward(q, k, v, out, g, lse,
                                         causal=causal)
    want = att.flash_attention_backward_reference(q, k, v, out, g, lse,
                                                  causal=causal)
    torch.cuda.synchronize()
    err = max(rel_err(a, w) for a, w in zip(got, want))
    same = all(torch.equal(a, r) for a, r in zip(got, again))
    log("  flash bwd %-8s B=%d H=%d T=%d S=%d D=%d causal=%d%s  "
        "err(dq,dk,dv)=%.3e lse_err=%.3e repeat=%s"
        % (name, b, h, t, s, d, causal,
           (" offset=%d" % offset if offset else "")
           + (" nan_tail" if nan_tail else ""), err, lse_err,
           "bit-identical" if same else "DIFFERS"))
    if not err <= BWD_TOL[dtype]:
        raise AssertionError(
            "flash backward kernel disagrees with its plain version: %r > "
            "%r at %s" % (err, BWD_TOL[dtype], (case, name, offset)))
    if not same:
        raise AssertionError("flash backward is not deterministic: a "
                             "second call differs at %s" % ((case, name),))
    return err


def phase_backward(att, gen, parents=()):
    """Flash backward kernel vs its plain version on the same q, k, v, o,
    dO and lse (the plain forward's), and the forward kernel's lse vs the
    plain lse: at the LM's shapes and at edge cases, in float32 (error
    scaled by max(1, max |plain|) <= BWD_TOL) and bfloat16, each call
    repeated and held bit for bit. Then, at the LM's shape, CUDA-event
    times beside the plain version, the bound, the route's figure and
    SDPA's backward alone (torch.autograd.grad on a retained graph; timed
    as a yardstick only, never called by the port); with ``parents``,
    each other tree's backward and this tree's in turns. Returns the
    timed rows and the worst error by type."""
    F = torch.nn.functional
    cases = [(1, 12, 1024, 1024, 64, True), (4, 12, 1024, 1024, 64, True),
             (2, 4, 1024, 1024, 64, False)]
    # around the 16-row warp tiles and the 64-row block tiles, T != S
    # under the causal mask (top-left), a single key or row, no key
    for t, s in [(1, 1), (15, 15), (16, 16), (17, 17), (63, 63), (64, 64),
                 (65, 65), (127, 127), (129, 129), (63, 129), (129, 63),
                 (15, 129), (129, 17), (1, 65), (65, 1), (64, 0), (17, 0)]:
        for causal in (True, False):
            cases.append((2, 3, t, s, 64, causal))
    for d in (32, 128):
        cases += [(2, 4, 200, 200, d, True), (2, 4, 129, 65, d, False),
                  (1, 3, 65, 129, d, True), (1, 3, 17, 15, d, True)]
    worst = {}
    for dtype in (torch.float32, torch.bfloat16):
        for case in cases:
            err = check_bwd_case(att, case, dtype, gen)
            worst[dtype] = max(worst.get(dtype, 0.0), err)
        # NaN past every end; views not 16-byte aligned (plain loads)
        for case, offset, tail in [((2, 3, 129, 65, 64, True), 0, 4096),
                                   ((2, 3, 65, 129, 64, False), 0, 4096),
                                   ((2, 3, 130, 190, 64, True), 1, 64),
                                   ((1, 2, 100, 100, 128, False), 3, 64),
                                   ((1, 2, 77, 77, 32, True), 1, 0)]:
            err = check_bwd_case(att, case, dtype, gen, offset, tail)
            worst[dtype] = max(worst.get(dtype, 0.0), err)

    timed = []
    for dtype in (torch.float32, torch.bfloat16):
        name = str(dtype).split(".")[1]
        for b in BUCKETS:
            h, t, d = 12, LM["seq_len"], 64
            q, k, v, g = (torch.randn(b, h, t, d, device="cuda",
                                      generator=gen).to(dtype)
                          for _ in range(4))
            out, lse = att._flash_cuda(q, k, v, True, d ** -0.5,
                                       want_lse=True)

            def kern():
                return att.flash_attention_backward(q, k, v, out, g, lse,
                                                    causal=True)

            def plain():
                return att.flash_attention_backward_reference(
                    q, k, v, out, g, lse, causal=True)

            got, want = kern(), plain()
            err = max(rel_err(a, w) for a, w in zip(got, want))
            aerr = max(abs_err(a, w) for a, w in zip(got, want))
            del want
            ms = cuda_ms(kern, 20)
            plain_ms = cuda_ms(plain, 5)
            qs, ks, vs = (x.detach().requires_grad_() for x in (q, k, v))
            o_lib = F.scaled_dot_product_attention(qs, ks, vs, is_causal=True)
            lib_ms = cuda_ms(lambda: torch.autograd.grad(
                o_lib, (qs, ks, vs), g, retain_graph=True), 20)
            del o_lib
            fwd_ms = cuda_ms(lambda: att.flash_attention(q, k, v,
                                                         causal=True), 20)
            fwd_lse_ms = cuda_ms(lambda: att._flash_cuda(
                q, k, v, True, d ** -0.5, want_lse=True), 20)
            bound_ms, bound_by = backward_bound_ms(b, h, t, t, d, True, dtype)
            route_ms = backward_route_ms(b, h, t, t, d, True, dtype)
            row = dict(dtype=name, B=b, max_abs_err=aerr, scaled_err=err,
                       ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
                       bound_ms=bound_ms, bound_by=bound_by,
                       route_ms=route_ms, fwd_ms=fwd_ms,
                       fwd_lse_ms=fwd_lse_ms)
            log("  flash bwd %s causal B=%d H=%d T=S=%d D=%d: kernel %.4f "
                "ms, plain %.4f ms, sdpa bwd %.4f ms (kernel/sdpa %.2f), "
                "bound %.4f ms (%s; kernel at %.1f%% of it; the 7-product "
                "route's figure %.4f ms, kernel at %.1f%% of it), max abs "
                "err %.3e, scaled err %.3e; forward %.4f ms, with lse %.4f ms"
                % (name, b, h, t, d, ms, plain_ms, lib_ms, ms / lib_ms,
                   bound_ms, bound_by, 100.0 * bound_ms / ms, route_ms,
                   100.0 * route_ms / ms, aerr, err, fwd_ms, fwd_lse_ms))
            row["turns"] = []
            for parent in parents:
                this_k = att._kernel(att.BWD_KERNEL)
                pk = parent.kernels["flash_attn_bwd"]
                args = (q, k, v, out, g, lse, True, d ** -0.5)
                perr = max(rel_err(a, w) for a, w in zip(
                    att._launch_bwd(pk, *args), got))
                p_ms, t_ms = in_turns(lambda: att._launch_bwd(pk, *args),
                                      lambda: att._launch_bwd(this_k, *args),
                                      20)
                row["turns"].append(dict(parent=parent.csrc, parent_ms=p_ms,
                                         this_ms=t_ms, scaled_diff=perr))
                log("    in turns with %s (parent, this, this, parent): "
                    "%.4f, %.4f, %.4f, %.4f ms (parent/this %.2f); scaled "
                    "diff %.3e" % (parent.csrc, p_ms[0], t_ms[0], t_ms[1],
                                   p_ms[1], sum(p_ms) / sum(t_ms), perr))
            del got
            timed.append(row)
    return timed, worst


def epilogue_bound_ms(shape, axis, dtype, residual):
    """Least time for one epilogue pass: x (and the residual) read and y
    written once plus scale and shift, against the HBM rate; or its f32
    operations (mul, add, compare, and the residual's add) against the
    f32 peak; whichever is larger."""
    n = 1
    for d in shape:
        n *= d
    esize = torch.empty((), dtype=dtype).element_size()
    nbytes = n * esize * (3 if residual else 2) + 2 * shape[axis] * 4
    ops = n * (4 if residual else 3)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / PEAK_OPS_PER_S[torch.float32] * 1e3
    return max(bytes_ms, ops_ms), ("bytes" if bytes_ms >= ops_ms
                                   else "operations")


def bit_err(got, want):
    """0.0 when got equals want bit for bit up to NaN payloads (NaN at the
    same places, every other value equal); else the largest difference
    (inf when the NaN positions differ)."""
    nan = torch.isnan(want)
    if not torch.equal(torch.isnan(got), nan):
        return float("inf")
    g, w = got[~nan], want[~nan]
    same = g == w
    if bool(same.all()):
        return 0.0
    return (g[~same].float() - w[~same].float()).abs().max().item()


def epilogue_inputs(shape, axis, dtype, residual, gen):
    c = shape[axis]
    x = (torch.randn(shape, device="cuda", generator=gen) * 2).to(dtype)
    r = torch.randn(shape, device="cuda", generator=gen).to(dtype) \
        if residual else None
    scale = torch.rand(c, device="cuda", generator=gen) + 0.5
    shift = torch.randn(c, device="cuda", generator=gen) * 0.5
    return x, scale, shift, r


def phase_epilogue(epi, gen):
    """Epilogue kernel vs its plain version, bit for bit; returns the
    timed rows (the main one is bn0 at bucket 32, f32, as served)."""
    checked = 0
    for dtype in (torch.float32, torch.bfloat16):
        for shape, axis, plant in [c + (False,) for c in EPILOGUE_CASES] + [
                ((257, 40), -1, True), ((2, 6, 9, 9), 1, True)]:
            for residual in (False, True):
                x, s, b, r = epilogue_inputs(shape, axis, dtype, residual,
                                             gen)
                if plant:  # NaN and +-inf in x
                    flat = x.view(-1)
                    flat[::7] = float("nan")
                    flat[3::11] = float("inf")
                    flat[5::13] = float("-inf")
                got = epi.bn_apply_relu_add(x, s, b, r, axis=axis)
                want = epi.bn_apply_relu_add_reference(x, s, b, r,
                                                       axis=axis)
                torch.cuda.synchronize()
                err = bit_err(got, want)
                if err != 0.0:
                    raise AssertionError(
                        "epilogue kernel differs from its plain version: "
                        "err %r at %s %s %s residual=%s"
                        % (err, shape, axis, dtype, residual))
                checked += 1
    log("  epilogue: %d cases (%d shapes incl. NaN/inf planted, f32 and "
        "bf16, with and without residual) equal the plain version bit "
        "for bit" % (checked, len(EPILOGUE_CASES) + 2))

    timed = []
    for (shape, axis), dtype, residual in [
            (EPILOGUE_MAIN, torch.float32, False),
            (EPILOGUE_MAIN, torch.bfloat16, False),
            (EPILOGUE_MAIN, torch.float32, True),
            (((401408, 64), -1), torch.float32, False),
            (((32, 2048, 7, 7), 1), torch.float32, False),
            (((1568, 2048), -1), torch.float32, False)]:
        x, s, b, r = epilogue_inputs(shape, axis, dtype, residual, gen)

        def kern():
            return epi.bn_apply_relu_add(x, s, b, r, axis=axis)

        def plain():
            return epi.bn_apply_relu_add_reference(x, s, b, r, axis=axis)

        err = bit_err(kern(), plain())
        ms = cuda_ms(kern, 100)
        plain_ms = cuda_ms(plain, 20)
        bound_ms, bound_by = epilogue_bound_ms(shape, axis, dtype, residual)
        row = dict(shape=list(shape), axis=axis,
                   dtype=str(dtype).split(".")[1], residual=residual,
                   max_abs_err=err, ms=ms, plain_ms=plain_ms,
                   bound_ms=bound_ms, bound_by=bound_by, library_ms=None)
        log("  epilogue %-8s %s axis=%d residual=%d: kernel %.4f ms, plain "
            "%.4f ms, bound %.4f ms (%s; kernel at %.1f%% of it), err %g"
            % (row["dtype"], shape, axis, residual, ms, plain_ms, bound_ms,
               bound_by, 100.0 * bound_ms / ms, err))
        timed.append(row)
    return timed


def resnet_params(sym, seed):
    """Seeded random weights and BN statistics (numpy): He-scaled conv
    weights, with each unit's last conv at a quarter of that so the
    residual stream stays near unit scale over 16 units (at full He scale
    it grows ~1000x and the softmax is one-hot); gamma in U(0.5, 1.5),
    beta in U(-0.1, 0.1), moving_mean in N(0, 0.1), moving_var in
    U(0.5, 1.5), so the folded scale and shift are not trivial; the
    classifier N(0, 1/fan_in)."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, aux_shapes = sym.infer_shape(
        data=(1,) + RESNET["image_shape"])
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        fan_in = int(np.prod(shape[1:])) if len(shape) > 1 else 1
        if name.endswith("_gamma"):
            w = rng.uniform(0.5, 1.5, shape)
        elif name.endswith("_beta"):
            w = rng.uniform(-0.1, 0.1, shape)
        elif name.endswith("_bias"):
            w = np.zeros(shape)
        elif name.startswith("fc"):
            w = rng.standard_normal(shape) / np.sqrt(fan_in)
        else:
            w = rng.standard_normal(shape) * np.sqrt(2.0 / fan_in)
            if name.endswith("_conv3_weight"):
                w *= 0.25
        params["arg:" + name] = w.astype(np.float32)
    for name, shape in zip(sym.list_auxiliary_states(), aux_shapes):
        w = rng.normal(0.0, 0.1, shape) if name.endswith("_moving_mean") \
            else rng.uniform(0.5, 1.5, shape)
        params["aux:" + name] = w.astype(np.float32)
    return params


def phase_resnet(mt, epi, seed, card, profile=False):
    sym = mt.models.get_resnet(**RESNET)
    sym_json = sym.tojson()
    t0 = time.perf_counter()
    params = resnet_params(sym, seed)
    n_params = sum(v.size for v in params.values())
    log("  ResNet-50 v2 %s: %d parameters + statistics (%.3f GB f32), made "
        "in %.1f s" % (RESNET, n_params, n_params * 4 / 1e9,
                       time.perf_counter() - t0))
    shape = (1,) + RESNET["image_shape"]
    rng = np.random.default_rng(seed + 1)
    requests = [rng.standard_normal(shape, dtype=np.float32)
                for _ in range(RESNET_REQUESTS)]

    t0 = time.perf_counter()
    session = mt.serving.ServingSession(
        sym_json, params, {"data": shape}, buckets=RESNET_BUCKETS,
        contexts=[mt.gpu(0)], warmup=True)
    log("  session up in %.2f s; warmup batch ms %s"
        % (time.perf_counter() - t0, session.warmup_ms))
    answers = [None] * RESNET_REQUESTS
    latency = [None] * RESNET_REQUESTS
    errors = []

    def client(idx):
        try:
            mine = list(range(idx, RESNET_REQUESTS, RESNET_CLIENTS))
            sent = [(r, time.perf_counter(),
                     session.predict_async({"data": requests[r]}))
                    for r in mine]
            for r, t, fut in sent:
                answers[r] = fut.wait(600)[0]
                latency[r] = (time.perf_counter() - t) * 1e3
        except Exception as exc:  # re-raised on the main thread below
            errors.append(exc)

    try:
        epi.bn_apply_relu_add.launches = 0  # count the main path alone
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(RESNET_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = epi.bn_apply_relu_add.launches
        batches = session.metrics.counter("batches_dispatched").value
        stats = session.stats()
        sites = session.pool.replicas[0].base._executor.fused_sites
    finally:
        session.close()
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads) or any(a is None
                                                   for a in answers):
        raise AssertionError("not every request was answered")
    for r, out in enumerate(answers):
        if out.shape != (1, RESNET["num_classes"]):
            raise AssertionError("answer %d has shape %s" % (r, out.shape))
        if not np.isfinite(out).all():
            raise AssertionError("answer %d is not finite" % r)
        dev = np.abs(out.sum(axis=1, dtype=np.float64) - 1.0).max()
        if dev > 1e-4:
            raise AssertionError("answer %d rows sum to 1 +- %g" % (r, dev))
    if sites != RESNET_SITES:
        raise AssertionError("executor fused %d BatchNorm->ReLU sites, not "
                             "%d" % (sites, RESNET_SITES))
    if batches < 1 or launches != RESNET_SITES * batches:
        raise AssertionError("epilogue launches %d != %d sites x %d batches"
                             % (launches, RESNET_SITES, batches))
    log("  %d requests in %d batches: %d fused sites, epilogue launches "
        "%d = %d x %d" % (RESNET_REQUESTS, batches, sites, launches,
                          RESNET_SITES, batches))
    lat = np.array(latency)
    top = np.array([a.max() for a in answers])
    log("  [%s] %.3f images/s; request latency ms (client): p50 %.1f, p99 "
        "%.1f, max %.1f; session request_latency_ms p50 %.1f p99 %.1f; "
        "batch_exec_ms mean %.2f; top probability min %.3g max %.3g"
        % (card, RESNET_REQUESTS / wall, np.percentile(lat, 50),
           np.percentile(lat, 99), lat.max(),
           stats["request_latency_ms"]["p50_ms"],
           stats["request_latency_ms"]["p99_ms"],
           stats["batch_exec_ms"]["mean_ms"], top.min(), top.max()))

    log("  batch_exec_ms of each batch: %s"
        % [round(v, 2) for v in
           session.metrics.histogram("batch_exec_ms")._values])
    x = np.concatenate(requests[:max(RESNET_BUCKETS)])
    breakdown = batch_breakdown(mt, sym_json, params, x, profile,
                                "ResNet-50")
    # every BatchNorm of ResNet-50 v2 feeds a ReLU, so the 50 fused sites
    # are its 50 BatchNorm outputs: their shapes at the largest bucket
    bn_nodes = [n for n in sym._topo() if not n.is_variable
                and n.op.name == "BatchNorm"]
    site_shapes = mt.sym.Group([mt.symbol.Symbol([(n, 0)])
                                for n in bn_nodes]).infer_shape(
        data=x.shape)[1]
    sites_bound_ms = sum(epilogue_bound_ms(tuple(s), 1, torch.float32,
                                           False)[0] for s in site_shapes)
    breakdown["epilogue_sites_bound_ms"] = sites_bound_ms
    log("  the %d epilogue sites of one bucket-%d forward: bound %.4f ms "
        "(bytes: each activation read and written once)"
        % (len(site_shapes), x.shape[0], sites_bound_ms))
    if profile:
        epi_ms = sum(v for k, v in breakdown["by_kernel_ms"].items()
                     if "planes_kernel" in k or "rows_kernel" in k)
        breakdown["epilogue_device_ms"] = epi_ms
        log("  their device time in the profiled forward: %.4f ms (at "
            "%.1f%% of the bound)" % (epi_ms, 100.0 * sites_bound_ms
                                      / max(epi_ms, 1e-9)))
    t0 = time.perf_counter()
    cpu_pred = mt.Predictor(sym_json, params, ctx=mt.cpu(),
                            input_shapes={"data": shape})
    cpu_pred.forward(data=requests[0])
    ref = cpu_pred.get_outputs()[0]
    abs_err = float(np.abs(answers[0] - ref).max())
    log("  gpu vs cpu Predictor on request 0: max abs err %.3e (cpu "
        "forward %.1f s)" % (abs_err, time.perf_counter() - t0))
    if not abs_err <= 1e-4:
        raise AssertionError("served ResNet-50 output disagrees with the "
                             "cpu path: %g" % abs_err)
    return dict(launches=launches, batches=batches, fused_sites=sites,
                images_per_s=RESNET_REQUESTS / wall, latency_ms=latency,
                session_stats=stats, warmup_ms=session.warmup_ms,
                cpu_abs_err=abs_err, n_params=int(n_params),
                breakdown=breakdown)


def lm_params(sym, seed):
    """Seeded random weights for every argument but the inputs (numpy)."""
    rng = np.random.default_rng(seed)
    arg_shapes, _, _ = sym.infer_shape(data=(1, LM["seq_len"]))
    params = {}
    for name, shape in zip(sym.list_arguments(), arg_shapes):
        if name in ("data", "softmax_label"):
            continue
        w = rng.standard_normal(shape, dtype=np.float32) * np.float32(0.02)
        if name.endswith("_gamma"):
            w += np.float32(1.0)
        params["arg:" + name] = w
    return params


def phase_serving(mt, att, seed, card, profile=False):
    sym = mt.models.get_transformer_lm(**LM)
    sym_json = sym.tojson()
    t0 = time.perf_counter()
    params = lm_params(sym, seed)
    n_params = sum(v.size for v in params.values())
    log("  LM %s: %d parameters (%.3f GB f32), made in %.1f s"
        % (LM, n_params, n_params * 4 / 1e9, time.perf_counter() - t0))
    rng = np.random.default_rng(seed + 1)
    requests = [rng.integers(0, LM["vocab_size"], (1, LM["seq_len"]))
                .astype(np.float32) for _ in range(N_REQUESTS)]

    t0 = time.perf_counter()
    session = mt.serving.ServingSession(
        sym_json, params, {"data": (1, LM["seq_len"])}, buckets=BUCKETS,
        contexts=[mt.gpu(0)], warmup=True)
    log("  session up in %.2f s; warmup batch ms %s"
        % (time.perf_counter() - t0, session.warmup_ms))
    answers = [None] * N_REQUESTS
    latency = [None] * N_REQUESTS
    errors = []

    def client(idx):
        try:
            for r in range(idx, N_REQUESTS, N_CLIENTS):
                t = time.perf_counter()
                answers[r] = session.predict({"data": requests[r]})[0]
                latency[r] = (time.perf_counter() - t) * 1e3
        except Exception as exc:  # re-raised on the main thread below
            errors.append(exc)

    try:
        att.flash_attention.launches = 0  # count the main path alone
        t0 = time.perf_counter()
        threads = [threading.Thread(target=client, args=(i,))
                   for i in range(N_CLIENTS)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=600)
        wall = time.perf_counter() - t0
        launches = att.flash_attention.launches
        batches = session.metrics.counter("batches_dispatched").value
    finally:
        session.close()
    if errors:
        raise errors[0]
    if any(th.is_alive() for th in threads) or any(a is None
                                                   for a in answers):
        raise AssertionError("not every request was answered")

    for r, out in enumerate(answers):
        if out.shape != (LM["seq_len"], LM["vocab_size"]):
            raise AssertionError("answer %d has shape %s" % (r, out.shape))
        if not np.isfinite(out).all():
            raise AssertionError("answer %d is not finite" % r)
        dev = np.abs(out.sum(axis=1, dtype=np.float64) - 1.0).max()
        if dev > 1e-4:
            raise AssertionError("answer %d rows sum to 1 +- %g" % (r, dev))
    if batches < 1 or launches != LM["num_layers"] * batches:
        raise AssertionError("flash launches %d != %d layers x %d batches"
                             % (launches, LM["num_layers"], batches))
    log("  %d requests in %d batches: flash launches %d = %d x %d"
        % (N_REQUESTS, batches, launches, LM["num_layers"], batches))
    lat = np.array(latency)
    log("  [%s] %.3f requests/s (%.0f tokens/s); request latency ms: "
        "p50 %.1f, max %.1f, all %s"
        % (card, N_REQUESTS / wall, N_REQUESTS * LM["seq_len"] / wall,
           np.median(lat), lat.max(), [round(x, 1) for x in latency]))

    breakdown = batch_breakdown(
        mt, sym_json, params, np.concatenate(requests[:max(BUCKETS)]),
        profile, "LM")
    t0 = time.perf_counter()
    cpu_pred = mt.Predictor(sym_json, params, ctx=mt.cpu(),
                            input_shapes={"data": (1, LM["seq_len"])})
    cpu_pred.forward(data=requests[0])
    ref = cpu_pred.get_outputs()[0]
    diff = np.abs(answers[0] - ref)
    abs_err = float(diff.max())
    rel_err = float((diff / np.maximum(np.abs(ref), 1e-30)).max())
    log("  gpu vs cpu Predictor on request 0: max abs err %.3e, max rel "
        "err %.3e (cpu forward %.1f s)"
        % (abs_err, rel_err, time.perf_counter() - t0))
    if not abs_err <= 1e-4 or not rel_err <= 1e-2:
        raise AssertionError("served output disagrees with the cpu path")
    return dict(launches=launches, batches=batches,
                requests_per_s=N_REQUESTS / wall,
                latency_ms=latency, warmup_ms=session.warmup_ms,
                cpu_abs_err=abs_err, cpu_rel_err=rel_err,
                n_params=int(n_params), breakdown=breakdown)


class RepeatBatch:
    """A DataIter over one batch, ``n`` times per epoch (the LM's labels
    are (B*T,), which NDArrayIter's one-row-per-example rule cannot
    carry)."""

    def __init__(self, mt, x, y, n):
        self._batch = mt.io.DataBatch(
            data=[mt.nd.array(x, ctx=mt.cpu())],
            label=[mt.nd.array(y, ctx=mt.cpu())], pad=0)
        self.provide_data = [mt.io.DataDesc("data", x.shape)]
        self.provide_label = [mt.io.DataDesc("softmax_label", y.shape)]
        self.n = n
        self._i = 0

    def __iter__(self):
        return self

    def __next__(self):
        if self._i >= self.n:
            raise StopIteration
        self._i += 1
        return self._batch

    def reset(self):
        self._i = 0


def lm_batch(seed, batch, seq_len, vocab):
    """Seeded tokens (B, T) and next-token labels (B*T,), float32."""
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, vocab, (batch, seq_len + 1))
    return (ids[:, :-1].astype(np.float32),
            ids[:, 1:].reshape(-1).astype(np.float32))


def phase_training(mt, att, seed, card, profile=False):
    """The LM trained through Module.fit on gpu(0) at GPT-2-small widths
    and depth: Xavier weights from a numpy seed, Adam, one fixed batch
    repeated TRAIN["steps"] times. Checks finite, falling cross-entropy
    and exactly one flash forward and one flash backward launch per layer
    per step; times the steps; then holds one step of a 2-layer model at
    full width, B = 1, against a cpu() Module from the same weights."""
    cfg = dict(LM)
    sym = mt.models.get_transformer_lm(**cfg)
    b, t, steps = TRAIN["batch"], cfg["seq_len"], TRAIN["steps"]
    x, y = lm_batch(seed, b, t, cfg["vocab_size"])
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    np.random.seed(seed)
    t0 = time.perf_counter()
    mod.bind(data_shapes=[("data", x.shape)],
             label_shapes=[("softmax_label", y.shape)])
    mod.init_params(mt.init.Xavier())
    n_params = sum(int(np.prod(a.shape))
                   for a in mod._exec.arg_dict.values()) - x.size - y.size
    log("  LM %s, B=%d: %d parameters, bound and initialized in %.1f s"
        % (cfg, b, n_params, time.perf_counter() - t0))
    ce, stamps = [], []

    def record(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        ce.append(param.eval_metric.get()[1])
        param.eval_metric.reset()

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    it = RepeatBatch(mt, x, y, steps)
    att.flash_attention.launches = 0  # count the main path alone
    att.flash_attention_backward.launches = 0
    t_start = time.perf_counter()
    mod.fit(it, num_epoch=1, eval_metric="ce", optimizer="adam",
            optimizer_params={"learning_rate": TRAIN["lr"]},
            initializer=None, batch_end_callback=record, metric_sync=1)
    fwd = att.flash_attention.launches
    bwd = att.flash_attention_backward.launches
    peak = torch.cuda.max_memory_allocated()
    ms = [float(v) for v in np.diff([t_start] + stamps) * 1e3]
    want = cfg["num_layers"] * steps
    log("  cross-entropy by step: %s" % [round(v, 4) for v in ce])
    log("  flash launches: forward %d, backward %d (want %d = %d layers x "
        "%d steps)" % (fwd, bwd, want, cfg["num_layers"], steps))
    if len(ce) != steps or not np.all(np.isfinite(ce)) or \
            not ce[-1] < ce[0]:
        raise AssertionError("LM training did not lower a finite "
                             "cross-entropy: %s" % ce)
    if fwd != want or bwd != want:
        raise AssertionError("flash launches fwd %d / bwd %d != %d"
                             % (fwd, bwd, want))
    warm = np.array(ms[TRAIN["warmup"]:])
    row = dict(batch=b, steps=steps, ce=ce, step_ms=ms,
               step_ms_mean=float(warm.mean()),
               tokens_per_s=float(b * t / (warm.mean() / 1e3)),
               max_memory_allocated=int(peak), n_params=n_params,
               fwd_launches=fwd, bwd_launches=bwd)
    log("  [%s] step ms %s; mean after %d warm-up steps %.2f ms, %.0f "
        "tokens/s; max_memory_allocated %.2f GB"
        % (card, [round(v, 1) for v in ms], TRAIN["warmup"],
           row["step_ms_mean"], row["tokens_per_s"], peak / 1e9))
    row["step_paths_ms"] = time_step_paths(mt, mod, x, y, card)
    if profile:
        row["profile"] = profile_step(mod, x, y, mt)
    del mod
    torch.cuda.empty_cache()
    row.update(train_step_vs_cpu(mt, seed))
    return row


def time_step_paths(mt, mod, x, y, card, pairs=10, n=3):
    """Host-clock ms of single training steps (``forward_backward`` +
    ``update``), each ended by a device sync, with the update through the
    fused rules (Adam) and through the Updater (an Adam subclass, which
    has no fused rule): ``pairs`` turns of each, ordered fused, updater,
    updater, fused, ..., of ``n`` steps, the first step of a turn not
    counted. Each turn starts a fresh optimizer
    (``init_optimizer(force_init=True)``), which leaves the work of a
    step unchanged."""

    class AdamByUpdater(mt.optimizer.Adam):
        pass

    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                         label=[mt.nd.array(y, ctx=mt.cpu())])
    rescale = 1.0 / x.shape[0]
    turns = {"fused": [], "updater": []}
    for path in (["fused", "updater", "updater", "fused"] * pairs)[
            :2 * pairs]:
        klass = mt.optimizer.Adam if path == "fused" else AdamByUpdater
        mod.init_optimizer(optimizer=klass(learning_rate=TRAIN["lr"],
                                           rescale_grad=rescale),
                           force_init=True)
        if (mod._fused is not None) != (path == "fused"):
            raise AssertionError("the %s turn did not arm its update" % path)
        ms = []
        for i in range(n):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            mod.forward_backward(db)
            mod.update()
            torch.cuda.synchronize()
            if i:
                ms.append((time.perf_counter() - t0) * 1e3)
        turns[path].append(float(np.mean(ms)))
    wins = sum(u > f for f, u in zip(turns["fused"], turns["updater"]))
    q = {k: [float(v) for v in np.percentile(t, [25, 50, 75])]
         for k, t in turns.items()}
    log("  [%s] one step, host clock to a device sync, %d turns each: "
        "fused update median %.2f ms (quartiles %.2f-%.2f); Updater median "
        "%.2f ms (quartiles %.2f-%.2f); Updater/fused %.3f; fused faster "
        "in %d of %d pairs"
        % (card, pairs, q["fused"][1], q["fused"][0], q["fused"][2],
           q["updater"][1], q["updater"][0], q["updater"][2],
           q["updater"][1] / q["fused"][1], wins, pairs))
    return dict(turns_ms=turns, quartiles_ms=q, fused_wins=wins,
                pairs=pairs)


def profile_step(mod, x, y, mt):
    """One fused training step under torch.profiler: device time by
    kernel."""
    from torch.profiler import ProfilerActivity, profile as _prof
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                         label=[mt.nd.array(y, ctx=mt.cpu())])
    mod.forward_backward(db)
    mod.update()
    torch.cuda.synchronize()
    with _prof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        mod.forward_backward(db)
        mod.update()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    total = sum(e.device_time_total for e in events)
    log("  profiled training step: %.2f ms of device time in %d kernels"
        % (total / 1e3, len(events)))
    for e in sorted(events, key=lambda e: -e.device_time_total)[:14]:
        log("    %8.3f ms %5.1f%%  x%-4d %s"
            % (e.device_time_total / 1e3,
               100.0 * e.device_time_total / max(total, 1e-9), e.count,
               e.key[:90]))
    bwd = {e.key: e.device_time_total / 1e3 for e in events
           if "flash_bwd_" in e.key}
    log("  the flash backward's kernels in the step: %.3f ms (%.1f%%): %s"
        % (sum(bwd.values()), 100.0 * sum(bwd.values()) * 1e3
           / max(total, 1e-9), {k[:40]: round(v, 3) for k, v in
                                 bwd.items()}))
    return {"device_ms": total / 1e3, "flash_bwd_ms": sum(bwd.values()),
            "by_kernel_ms": {e.key: e.device_time_total / 1e3
                             for e in events}}


def _grads_f64(mt, sym, weights, x, y, aux=None):
    """The gradient of every parameter in float64 on the CPU (the
    executor with float64 arrays), from ``weights`` (cpu NDArrays); with
    ``aux`` (cpu NDArrays) also the aux values that training forward
    wrote back, as (grads, aux)."""
    def f64(t):
        return mt.nd.NDArray(t.double(), mt.cpu())

    args = {n: f64(v._data) for n, v in weights.items()}
    args["data"] = f64(torch.from_numpy(x))
    args["softmax_label"] = f64(torch.from_numpy(y))
    grads = {n: mt.nd.NDArray(torch.zeros_like(v._data), mt.cpu())
             for n, v in args.items() if n in weights}
    aux64 = {n: f64(v._data) for n, v in (aux or {}).items()}
    exe = sym.bind(mt.cpu(), args, args_grad=grads, aux_states=aux64)
    exe.forward(is_train=True)
    exe.backward()
    g = {n: t._data.numpy() for n, t in grads.items()}
    if aux is None:
        return g
    return g, {n: v._data.numpy() for n, v in aux64.items()}


def train_step_vs_cpu(mt, seed):
    """One SGD step of a 2-layer LM at full width, B = 1, on gpu(0) and
    on cpu() from the same weights, against the exact step (a float64
    gradient on the CPU, through the plain versions). Both f32 steps run
    with TF32 off. f32 is far from exact on this model (a LayerNorm over
    small Xavier-scale embeddings multiplies the gradient, and the sums
    over 1024 tokens and 50257 classes cancel), so the gate is relative:
    the GPU step's largest distance from the exact step must stay within
    TRAIN_CPU_FACTOR times the CPU f32 step's own, and the step's outputs
    (probabilities, before the update) within TRAIN_OUT_RTOL of the CPU's,
    element by element. A third step, on gpu(0) with TF32 GEMMs, is the
    control: a GPU step of lower precision that both gates must refuse."""
    cfg = dict(LM, num_layers=2)
    sym = mt.models.get_transformer_lm(**cfg)
    x, y = lm_batch(seed + 1, 1, cfg["seq_len"], cfg["vocab_size"])
    db = mt.io.DataBatch(data=[mt.nd.array(x, ctx=mt.cpu())],
                         label=[mt.nd.array(y, ctx=mt.cpu())])
    np.random.seed(seed + 1)
    got = {}
    weights = None
    t0 = time.perf_counter()
    tf32_was = torch.backends.cuda.matmul.allow_tf32
    for run, ctx, tf32 in (("gpu", mt.gpu(0), False),
                           ("gpu_tf32", mt.gpu(0), True),
                           ("cpu", mt.cpu(), False)):
        mod = mt.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        if weights is None:
            mod.init_params(mt.init.Xavier())
            weights = mod.get_params()[0]
        else:
            mod.init_params(arg_params=weights)
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": TRAIN_CPU_LR})
        torch.backends.cuda.matmul.allow_tf32 = tf32
        try:
            mod.forward_backward(db)
            mod.update()
            got[run] = (mod.get_outputs()[0].asnumpy(),
                        {k: v.asnumpy() for k, v in
                         mod.get_params()[0].items()})
        finally:
            torch.backends.cuda.matmul.allow_tf32 = tf32_was
        del mod
    g64 = _grads_f64(mt, sym, weights, x, y)
    exact = {k: weights[k].asnumpy().astype(np.float64) - TRAIN_CPU_LR * g
             for k, g in g64.items()}  # SGD, rescale_grad 1/B = 1, wd 0
    c_out, c_w = got["cpu"]

    def out_err(o):
        return float((np.abs(o - c_out) / np.maximum(np.abs(c_out),
                                                     1e-30)).max())

    def dist(w):
        return max(float(np.abs(w[k] - exact[k]).max()) for k in exact)

    cpu_err = dist(c_w)
    res = {"cpu_exact_err": cpu_err,
           "cpu_weight_moved": max(float(np.abs(
               c_w[k] - weights[k].asnumpy()).max()) for k in c_w)}
    for run in ("gpu", "gpu_tf32"):
        o, w = got[run]
        res[run] = {"out_rel_err": out_err(o),
                    "out_abs_err": float(np.abs(o - c_out).max()),
                    "exact_err": dist(w),
                    "weight_err": max(float(np.abs(w[k] - c_w[k]).max())
                                      for k in c_w)}
        res[run]["exact_ratio"] = res[run]["exact_err"] / max(cpu_err,
                                                              1e-30)
        log("  2-layer full-width SGD step (lr %g), %s vs cpu: outputs max "
            "rel err %.3e (abs %.3e); updated weights %.3e apart; distance "
            "from the exact (float64) step %.3e vs the cpu f32 step's %.3e "
            "(ratio %.2f)" % (TRAIN_CPU_LR, run, res[run]["out_rel_err"],
                              res[run]["out_abs_err"],
                              res[run]["weight_err"], res[run]["exact_err"],
                              cpu_err, res[run]["exact_ratio"]))
    log("  the step moved weights by up to %.3e; three steps and the "
        "float64 gradient in %.1f s" % (res["cpu_weight_moved"],
                                        time.perf_counter() - t0))
    gpu, ctl = res["gpu"], res["gpu_tf32"]
    if not gpu["out_rel_err"] <= TRAIN_OUT_RTOL or \
            not gpu["exact_ratio"] <= TRAIN_CPU_FACTOR:
        raise AssertionError(
            "gpu training step disagrees with the cpu step: outputs rel %g "
            "(gate %g); distance from the exact step %g x the cpu's (gate "
            "%g)" % (gpu["out_rel_err"], TRAIN_OUT_RTOL, gpu["exact_ratio"],
                     TRAIN_CPU_FACTOR))
    if ctl["out_rel_err"] <= TRAIN_OUT_RTOL or \
            ctl["exact_ratio"] <= TRAIN_CPU_FACTOR:
        raise AssertionError(
            "the TF32 control step passed a gate (outputs rel %g, gate %g; "
            "exact-step ratio %g, gate %g): the gates cannot tell f32 from "
            "TF32" % (ctl["out_rel_err"], TRAIN_OUT_RTOL,
                      ctl["exact_ratio"], TRAIN_CPU_FACTOR))
    return res


def resnet_train_data(seed):
    """512 seeded images in [0, 1) (308 MB f32) and labels of 1000
    classes, as bench.py makes its batch."""
    rng = np.random.RandomState(seed)
    n = RESNET_TRAIN["images"]
    x = rng.rand(n, *RESNET["image_shape"]).astype(np.float32)
    y = rng.randint(0, RESNET["num_classes"], n).astype(np.float32)
    return x, y


class TimedCallback:
    """An epoch-end callback timed on the host clock, device work before
    and after it synchronized."""

    def __init__(self, fn):
        self.fn = fn
        self.ms = []

    def __call__(self, *args):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        self.fn(*args)
        torch.cuda.synchronize()
        self.ms.append((time.perf_counter() - t0) * 1e3)


def phase_resnet_training(mt, epi, seed, card, profile=False):
    """ResNet-50 v2 at 224x224 trained through Module.fit on gpu(0): f32
    with TF32 off, B=256, Xavier weights from a numpy seed, SGD, 4 epochs
    over 512 seeded images with ``device_prefetch`` and a ``do_checkpoint``
    at each epoch's end, acc and ce on the device. Gates: a finite
    cross-entropy at every step that ends lower than it starts; every
    moving statistic finite and moved; the last checkpoint reloaded by
    ``Module.load`` on gpu(0) bit for bit the live params and statistics;
    the trained model's evaluation forward launching the epilogue once at
    each of its 50 sites and within 1e-4 of the same forward through the
    epilogue's plain version; and resnet-8's one-step gate
    (``resnet8_step_vs_cpu``). Reports step ms, images/s, MFU, peak
    memory, the input copy with and without the prefetcher, the device
    time of the BatchNorm-train->ReLU pairs on their own, and with
    ``profile`` one step's device time by kernel."""
    import tempfile
    cfg = RESNET_TRAIN
    b, epochs = cfg["batch"], cfg["epochs"]
    steps = epochs * cfg["images"] // b
    sym = mt.models.get_resnet(**RESNET)
    t0 = time.perf_counter()
    x, y = resnet_train_data(seed)
    log("  %d seeded images (%.0f MB f32) in %.1f s"
        % (len(x), x.nbytes / 1e6, time.perf_counter() - t0))
    mod = mt.mod.Module(sym, context=mt.gpu(0))
    ce, stamps = [], []

    def record(param):
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        ce.append(dict(zip(*param.eval_metric.get()))["cross-entropy"])
        param.eval_metric.reset()

    tmp = tempfile.mkdtemp(prefix="chip_smoke_ckpt_")
    prefix = os.path.join(tmp, "resnet50")
    ckpt = TimedCallback(mt.callback.do_checkpoint(prefix))
    try:
        np.random.seed(seed)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        epi.bn_apply_relu_add.launches = 0  # the training walk fuses none
        t_start = time.perf_counter()
        mod.fit(mt.io.NDArrayIter(x, y, batch_size=b), num_epoch=epochs,
                eval_metric=["acc", "ce"], optimizer="sgd",
                optimizer_params={"learning_rate": cfg["lr"],
                                  "momentum": cfg["momentum"],
                                  "rescale_grad": 1.0 / b},
                initializer=mt.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2),
                batch_end_callback=record, epoch_end_callback=ckpt,
                metric_sync=1, device_prefetch=True)
        peak = torch.cuda.max_memory_allocated()
        train_launches = epi.bn_apply_relu_add.launches
        ms = [float(v) for v in np.diff([t_start] + stamps) * 1e3]
        log("  cross-entropy by step: %s" % [round(v, 4) for v in ce])
        if len(ce) != steps or not np.all(np.isfinite(ce)) or \
                not ce[-1] < ce[0]:
            raise AssertionError("ResNet-50 training did not lower a finite "
                                 "cross-entropy: %s" % ce)
        if train_launches:
            raise AssertionError("the training walk launched the epilogue "
                                 "%d times" % train_launches)
        warm = np.array(ms[cfg["warmup"]:])
        # every other step opens an epoch, after the last epoch's
        # checkpoint and the iterator's reset
        inner = np.array(ms[1::2][1:])
        row = dict(batch=b, steps=steps, ce=ce, step_ms=ms,
                   step_ms_mean=float(warm.mean()),
                   step_ms_within_epoch=float(inner.mean()),
                   checkpoint_ms=ckpt.ms,
                   images_per_s=float(b / (warm.mean() / 1e3)),
                   max_memory_allocated=int(peak))
        row["mfu"] = row["images_per_s"] * RESNET_FLOPS_PER_IMAGE / \
            PEAK_OPS_PER_S[torch.float32]
        log("  [%s] step ms %s; mean after %d warm-up steps %.2f ms (%.1f "
            "images/s, MFU %.1f%% of 67 TFLOP/s f32); steps inside an epoch "
            "%.2f ms; epoch-end checkpoints %s ms; max_memory_allocated "
            "%.2f GB" % (card, [round(v, 1) for v in ms], cfg["warmup"],
                         row["step_ms_mean"], row["images_per_s"],
                         100.0 * row["mfu"], row["step_ms_within_epoch"],
                         [round(v, 1) for v in ckpt.ms], peak / 1e9))

        args, aux = mod.get_params()
        for name, v in aux.items():
            t = v._data
            init = 0.0 if name.endswith("_moving_mean") else 1.0
            if not bool(torch.isfinite(t).all()) or \
                    bool((t == init).all()):
                raise AssertionError("moving statistic %s is not finite or "
                                     "did not move" % name)
        row["checkpoint_reload"] = check_checkpoint_reload(
            mt, prefix, epochs, sym, (args, aux), b)
        batch = mt.io.DataBatch([mt.nd.array(x[:b], ctx=mt.cpu())],
                                [mt.nd.array(y[:b], ctx=mt.cpu())])

        def forward():
            mod.forward(batch, is_train=False)
            return mod.get_outputs()[0]._data

        row.update(eval_forward_gate(
            epi, forward, lambda: mod._exec.fused_sites,
            "trained model's evaluation forward"))
        row["input_copy_ms"] = time_input_copy(mt, mod, x, y, card)
        if profile:
            row["profile"] = profile_device(
                lambda: (mod.forward_backward(batch), mod.update()),
                "ResNet-50 training step")
        row["bn_relu_pairs"] = pairs = time_bn_relu_pairs(mt, sym, b, card)
        log("  the pairs' forward+backward against the step: %.1f%% of its "
            "host-clock mean" % (100.0 * pairs["fwd_bwd_ms"]
                                 / row["step_ms_mean"]))
        if profile:
            dev = row["profile"]["device_ms"]
            # as phase 6 estimates it: a run's host-clock mean less one
            # profiled step's device time
            row["idle_share_estimate"] = 1.0 - dev / row["step_ms_mean"]
            log("  ... %.1f%% of the profiled step's %.2f ms of device "
                "time; idle share, an estimate: %.1f%%"
                % (100.0 * pairs["fwd_bwd_ms"] / dev, dev,
                   100.0 * row["idle_share_estimate"]))
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    del mod
    torch.cuda.empty_cache()
    row["resnet8_step"] = resnet8_step_vs_cpu(mt, seed)
    return row


def check_checkpoint_reload(mt, prefix, epoch, sym, live, b):
    """The epoch's checkpoint, loaded by Module.load on gpu(0), gives the
    live params and statistics bit for bit."""
    mod = mt.mod.Module.load(prefix, epoch, context=mt.gpu(0))
    mod.bind(data_shapes=[("data", (b,) + RESNET["image_shape"])],
             label_shapes=[("softmax_label", (b,))], for_training=False)
    if mod.symbol.tojson() != sym.tojson():
        raise AssertionError("the checkpoint's symbol is not the model's")
    worst = 0
    for want, got in zip(live, mod.get_params()):
        if sorted(want) != sorted(got):
            raise AssertionError("the checkpoint names other arrays")
        for k in want:
            if not torch.equal(want[k]._data, got[k]._data):
                worst += 1
    log("  checkpoint of epoch %d reloaded on gpu(0): %d arrays, %d not "
        "bit-identical" % (epoch, sum(map(len, live)), worst))
    if worst:
        raise AssertionError("%d reloaded arrays differ from the live ones"
                             % worst)
    del mod
    return {"arrays": sum(map(len, live)), "differ": worst}


def eval_forward_gate(epi, forward, sites, label):
    """A trained model's evaluation forward on one batch, ``forward()``
    returning its output tensor: the epilogue kernel launches once per
    fused site (``sites()``, read after the forward; 50), and the output
    is within 1e-4 of the same forward with each site through the
    epilogue's plain version (on the same card, the same trained
    statistics)."""
    from mxtpu_torch.ops import nn as nn_ops
    epi.bn_apply_relu_add.launches = 0
    got = forward().clone()
    torch.cuda.synchronize()
    launches = epi.bn_apply_relu_add.launches
    kernel = nn_ops.bn_apply_relu_add

    def plain(x, scale, shift, residual=None, axis=-1, **_):
        return epi.bn_apply_relu_add_reference(x, scale, shift, residual,
                                               axis)

    nn_ops.bn_apply_relu_add = plain
    try:
        want = forward().clone()
    finally:
        nn_ops.bn_apply_relu_add = kernel
    err = float((got - want).abs().max())
    n_sites = sites()
    log("  %s (B=%d): %d fused sites, epilogue launches %d; vs the plain "
        "epilogue max abs err %.3e; rows finite %s"
        % (label, got.shape[0], n_sites, launches, err,
           bool(torch.isfinite(got).all())))
    if n_sites != RESNET_SITES or launches != RESNET_SITES:
        raise AssertionError("%s: %d sites, %d epilogue launches (want %d)"
                             % (label, n_sites, launches, RESNET_SITES))
    if not err <= 1e-4 or not bool(torch.isfinite(got).all()):
        raise AssertionError("%s disagrees with the plain epilogue: %g"
                             % (label, err))
    return {"eval_launches": launches, "eval_max_abs_err": err}


def time_input_copy(mt, mod, x, y, card):
    """Host-clock ms to get a batch into the bound input arrays, over
    ``copy_steps`` training steps each: from the host (NDArrayIter, a
    pageable copy in ``Module._load_batch``) and through a
    DevicePrefetchIter (the wait on the staged batch and a device-to-
    device copy). Each step trains between the copies, so the producer
    can stage the next batch meanwhile."""
    b, n = RESNET_TRAIN["batch"], RESNET_TRAIN["copy_steps"]
    # n batches: the images again from the start where they run out
    x = np.concatenate([x] * -(-n * b // len(x)))[:n * b]
    y = np.concatenate([y] * -(-n * b // len(y)))[:n * b]
    out = {}
    for how in ("host", "prefetch", "prefetch", "host"):
        it = mt.io.NDArrayIter(x, y, batch_size=b)
        if how == "prefetch":
            it = mt.io.DevicePrefetchIter(it, device=mt.gpu(0))
        ms = []
        try:
            for _ in range(n):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                batch = next(it)
                mod._load_batch(batch)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                mod._exec.forward(is_train=True)
                mod._exec.backward()
                mod.update()
                torch.cuda.synchronize()
        finally:
            if how == "prefetch":
                it.close()
        out.setdefault(how, []).extend(ms)
    log("  [%s] input copy of a B=%d batch (%.0f MB), host clock to a sync,"
        " %d steps x 2 turns: from the host %s ms (mean %.2f); through the "
        "prefetcher %s ms (mean %.2f)"
        % (card, b, x[:b].nbytes / 1e6, n,
           [round(v, 2) for v in out["host"]], np.mean(out["host"]),
           [round(v, 2) for v in out["prefetch"]],
           np.mean(out["prefetch"])))
    return out


def profile_device(step, label):
    """``step()`` once to warm, then once under torch.profiler: device
    time by kernel, and grouped by kind (convolution, GEMM, reduction,
    elementwise, copy) from the kernels' names."""
    from torch.profiler import ProfilerActivity, profile as _prof
    step()
    torch.cuda.synchronize()
    with _prof(activities=[ProfilerActivity.CPU,
                           ProfilerActivity.CUDA]) as prof:
        step()
        torch.cuda.synchronize()
    events = [e for e in prof.key_averages()
              if getattr(e, "device_time_total", 0) > 0
              and e.device_type.name == "CUDA"]
    total = sum(e.device_time_total for e in events) / 1e3
    kinds = {}
    for e in events:
        k = e.key.lower()
        kind = ("convolution" if any(w in k for w in (
            "conv", "cudnn", "xmma", "implicit", "wgrad", "dgrad", "fprop",
            "winograd", "fft")) else
            "gemm" if "gemm" in k or "cutlass" in k else
            "reduction" if "reduce" in k else
            "elementwise" if "elementwise" in k else
            "copy" if "copy" in k or "memcpy" in k or "memset" in k else
            "other")
        kinds[kind] = kinds.get(kind, 0.0) + e.device_time_total / 1e3
    log("  profiled %s: %.2f ms of device time in %d kernels; by kind %s"
        % (label, total, len(events),
           {k: round(v, 2) for k, v in sorted(kinds.items())}))
    for e in sorted(events, key=lambda e: -e.device_time_total)[:16]:
        log("    %8.3f ms %5.1f%%  x%-4d %s"
            % (e.device_time_total / 1e3,
               100.0 * e.device_time_total / 1e3 / max(total, 1e-9),
               e.count, e.key[:90]))
    return {"device_ms": total, "by_kind_ms": kinds,
            "by_kernel_ms": {e.key: e.device_time_total / 1e3
                             for e in events}}


def time_bn_relu_pairs(mt, sym, b, card):
    """Device time of the step's 50 BatchNorm-train -> ReLU pairs on their
    own: at each site's shape, the port's BatchNorm in training and the
    ReLU forward, then their backward from a head gradient, timed with
    CUDA events (the same ops the training walk runs there), summed over
    the sites."""
    op = mt.ops.registry.get_op("BatchNorm")
    dev = mt.gpu(0).torch_device
    bn_nodes = [n for n in sym._topo() if not n.is_variable
                and n.op.name == "BatchNorm"]
    shapes = mt.sym.Group([mt.symbol.Symbol([(n, 0)]) for n in bn_nodes]) \
        .infer_shape(data=(b,) + RESNET["image_shape"])[1]
    gen = torch.Generator(device=dev).manual_seed(0)
    total_fwd = total_all = 0.0
    for node, shape in zip(bn_nodes, shapes):
        a = type(node.parsed_attrs())(node.parsed_attrs())
        a["__is_train__"] = True
        c = shape[1]
        x = torch.randn(shape, device=dev, generator=gen)
        g = torch.rand(c, device=dev, generator=gen) + 0.5
        beta = torch.zeros(c, device=dev)
        mm, mv = torch.zeros(c, device=dev), torch.ones(c, device=dev)
        head = torch.randn(shape, device=dev, generator=gen)
        xg, gg, bg = (t.clone().requires_grad_() for t in (x, g, beta))

        def fwd():
            with torch.no_grad():
                return torch.relu(op.apply(a, [x, g, beta, mm, mv])[0])

        def fwd_bwd():
            y = torch.relu(op.apply(a, [xg, gg, bg, mm, mv])[0])
            torch.autograd.grad(y, (xg, gg, bg), head)

        total_fwd += cuda_ms(fwd, 3, warmup=1)
        total_all += cuda_ms(fwd_bwd, 3, warmup=1)
        del x, head, xg
    torch.cuda.empty_cache()
    log("  [%s] the %d BatchNorm-train->ReLU pairs of a B=%d step on their "
        "own (CUDA events): forward %.2f ms, forward+backward %.2f ms"
        % (card, len(shapes), b, total_fwd, total_all))
    return {"sites": len(shapes), "fwd_ms": total_fwd,
            "fwd_bwd_ms": total_all}


def resnet8_step_vs_cpu(mt, seed):
    """One SGD step of resnet-8 at B=32 on gpu(0) and on cpu() from the
    same weights and statistics, against the exact step (float64 on the
    CPU): the GPU's updated weights and moving statistics no farther from
    it than TRAIN_CPU_FACTOR times the CPU f32 step's, and its outputs
    (probabilities before the update) within TRAIN_OUT_RTOL of the CPU's.
    A control step on gpu(0) with TF32 convolutions and GEMMs must fail a
    gate."""
    sym = mt.models.get_resnet(**RESNET8)
    rng = np.random.RandomState(seed + 2)
    x = rng.rand(RESNET8_BATCH, *RESNET8["image_shape"]).astype(np.float32)
    y = rng.randint(0, RESNET8["num_classes"], RESNET8_BATCH).astype(
        np.float32)
    db = mt.io.DataBatch([mt.nd.array(x, ctx=mt.cpu())],
                         [mt.nd.array(y, ctx=mt.cpu())])
    np.random.seed(seed + 2)
    got, start = {}, None
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    for run, ctx, tf32 in (("gpu", mt.gpu(0), False),
                           ("gpu_tf32", mt.gpu(0), True),
                           ("cpu", mt.cpu(), False)):
        mod = mt.mod.Module(sym, context=ctx)
        mod.bind(data_shapes=[("data", x.shape)],
                 label_shapes=[("softmax_label", y.shape)])
        if start is None:
            mod.init_params(mt.init.Xavier(rnd_type="gaussian",
                                           factor_type="in", magnitude=2))
            start = mod.get_params()
        else:
            mod.init_params(arg_params=start[0], aux_params=start[1])
        mod.init_optimizer(optimizer="sgd", optimizer_params={
            "learning_rate": RESNET8_LR})
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            mod.forward_backward(db)
            mod.update()
            got[run] = (mod.get_outputs()[0].asnumpy(),) + tuple(
                {k: v.asnumpy() for k, v in d.items()}
                for d in mod.get_params())
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
        del mod
    g64, aux64 = _grads_f64(mt, sym, start[0], x, y, aux=start[1])
    rescale = 1.0 / RESNET8_BATCH
    exact_w = {k: start[0][k].asnumpy().astype(np.float64)
               - RESNET8_LR * rescale * g for k, g in g64.items()}
    return step_gate(got, exact_w, aux64, ("gpu",), "resnet-8 SGD step "
                     "(B=%d, lr %g)" % (RESNET8_BATCH, RESNET8_LR))


def step_gate(got, exact_w, exact_a, runs, label):
    """Hold each GPU step of ``runs`` as phase 7 holds resnet-8: ``got``
    maps a run (those, "cpu" and the "gpu_tf32" control) to its outputs
    (probabilities before the update), updated weights and moving
    statistics; a step passes when its outputs are within TRAIN_OUT_RTOL
    of the CPU's, and its weights and statistics no farther from the
    exact (float64) step than TRAIN_CPU_FACTOR times the CPU f32 step's.
    The TF32 control must fail a gate."""
    c_out, c_w, c_a = got["cpu"]

    def dist(vals, exact):
        return max(float(np.abs(vals[k] - exact[k]).max()) for k in exact)

    res = {"cpu_weight_err": dist(c_w, exact_w),
           "cpu_stat_err": dist(c_a, exact_a)}
    for run in tuple(runs) + ("gpu_tf32",):
        o, w, a = got[run]
        r = res[run] = {
            "out_rel_err": float((np.abs(o - c_out) / np.maximum(
                np.abs(c_out), 1e-30)).max()),
            "weight_err": dist(w, exact_w), "stat_err": dist(a, exact_a)}
        r["weight_ratio"] = r["weight_err"] / max(res["cpu_weight_err"],
                                                  1e-30)
        r["stat_ratio"] = r["stat_err"] / max(res["cpu_stat_err"], 1e-30)
        r["ok"] = (r["out_rel_err"] <= TRAIN_OUT_RTOL and
                   r["weight_ratio"] <= TRAIN_CPU_FACTOR and
                   r["stat_ratio"] <= TRAIN_CPU_FACTOR)
        log("  %s, %s vs cpu: outputs max rel err %.3e; distance from the "
            "exact (float64) step: weights %.3e vs the cpu f32 step's %.3e "
            "(ratio %.2f), moving statistics %.3e vs %.3e (ratio %.2f)"
            % (label, run, r["out_rel_err"], r["weight_err"],
               res["cpu_weight_err"], r["weight_ratio"], r["stat_err"],
               res["cpu_stat_err"], r["stat_ratio"]))
    for run in runs:
        if not res[run]["ok"]:
            raise AssertionError("%s: the %s step disagrees with the cpu "
                                 "step: %s" % (label, run, res[run]))
    if res["gpu_tf32"]["ok"]:
        raise AssertionError("the TF32 control step passed every gate: the "
                             "gates cannot tell f32 from TF32: %s"
                             % res["gpu_tf32"])
    return res


def gluon_narrow(mt):
    v = mt.gluon.model_zoo.vision
    g = GLUON_NARROW
    return v.ResNetV2(v.BasicBlockV2, g["layers"], g["channels"],
                      classes=g["classes"], thumbnail=g["thumbnail"])


def gluon_stripped(net):
    return {k[len(net.prefix):]: p for k, p in net.collect_params().items()}


def gluon_train_steps(mt, net, trainer, loss_fn, batches, steps):
    """``steps`` steps of the users' loop: the next batch from the
    DataLoader, ``autograd.record()`` around the forward and the loss,
    ``backward()``, ``trainer.step(B)``, the loss read back (a device
    sync). Host-clock ms of each step and of its wait on the DataLoader,
    and the losses."""
    b = GLUON_TRAIN["batch"]
    step_ms, wait_ms, losses = [], [], []
    for _ in range(steps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        data, label = next(batches)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        with mt.autograd.record():
            loss = loss_fn(net(data), label)
        loss.backward()
        trainer.step(b)
        losses.append(float(loss.mean().asscalar()))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        wait_ms.append((t1 - t0) * 1e3)
        step_ms.append((t2 - t0) * 1e3)
    return step_ms, wait_ms, losses


def cycle(loader):
    while True:
        yield from loader


def phase_gluon(mt, epi, seed, card, module_row=None, profile=False):
    """Gluon's resnet50_v2 at 224x224 trained on gpu(0) through the
    port's autograd and Trainer (see the module docstring, phase 8).
    ``module_row`` is phase 7's result, printed beside for comparison;
    with ``profile``, one hybridized step on a batch already on the card
    is traced, and the idle share estimated from it."""
    cfg = GLUON_TRAIN
    b, warm = cfg["batch"], cfg["warmup"]
    x, y = resnet_train_data(seed)
    dataset = mt.gluon.data.ArrayDataset(x, y)
    np.random.seed(seed)
    net = mt.gluon.model_zoo.vision.resnet50_v2(
        classes=RESNET["num_classes"])
    net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                  magnitude=2), ctx=mt.gpu(0))
    net.hybridize()
    trainer = mt.gluon.Trainer(net.collect_params(), "sgd", {
        "learning_rate": cfg["lr"], "momentum": cfg["momentum"]})
    loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    epi.bn_apply_relu_add.launches = 0  # the training walks fuse none
    runs = {}
    for name, steps, workers, hybrid in (
            ("hybridized", cfg["hybrid_steps"], 0, True),
            ("imperative", cfg["imperative_steps"], 0, False),
            ("hybridized_workers", cfg["worker_steps"], cfg["num_workers"],
             True)):
        net.hybridize(hybrid)
        batches = cycle(mt.gluon.data.DataLoader(dataset, batch_size=b,
                                                 num_workers=workers))
        try:
            step_ms, wait_ms, losses = gluon_train_steps(
                mt, net, trainer, loss_fn, batches, steps)
        finally:
            batches.close()
        mean = float(np.mean(step_ms[warm:]))
        wait = float(np.mean(wait_ms[warm:]))
        runs[name] = dict(steps=steps, num_workers=workers, step_ms=step_ms,
                          wait_ms=wait_ms, losses=losses,
                          step_ms_mean=mean, wait_ms_mean=wait,
                          compute_ms_mean=mean - wait,
                          images_per_s=b / (mean / 1e3))
        runs[name]["mfu"] = runs[name]["images_per_s"] * \
            RESNET_FLOPS_PER_IMAGE / PEAK_OPS_PER_S[torch.float32]
        log("  [%s] %s (num_workers=%d): loss by step %s; step ms %s; mean "
            "after %d warm-up steps %.2f ms = DataLoader wait %.2f + compute "
            "%.2f (%.1f images/s, MFU %.1f%% of 67 TFLOP/s f32)"
            % (card, name, workers, [round(v, 4) for v in losses],
               [round(v, 1) for v in step_ms], warm, mean, wait, mean - wait,
               runs[name]["images_per_s"], 100.0 * runs[name]["mfu"]))
    peak = torch.cuda.max_memory_allocated()
    train_launches = epi.bn_apply_relu_add.launches
    row = dict(runs=runs, max_memory_allocated=int(peak))
    losses = [v for r in runs.values() for v in r["losses"]]
    hyb = runs["hybridized"]["losses"]
    if not np.all(np.isfinite(losses)) or not hyb[-1] < hyb[0]:
        raise AssertionError("Gluon ResNet-50 training did not lower a "
                             "finite loss: %s" % losses)
    if train_launches:
        raise AssertionError("the training walks launched the epilogue %d "
                             "times" % train_launches)
    mod_ms = (module_row or {}).get("step_ms_within_epoch")
    log("  [%s] step ms: Gluon hybridized %.2f, imperative %.2f, hybridized "
        "with %d DataLoader workers %.2f; phase 7's Module step inside an "
        "epoch %s; the DataLoader wait %.2f ms with no workers, %.2f with "
        "%d; max_memory_allocated %.2f GB"
        % (card, runs["hybridized"]["step_ms_mean"],
           runs["imperative"]["step_ms_mean"], cfg["num_workers"],
           runs["hybridized_workers"]["step_ms_mean"],
           "%.2f" % mod_ms if mod_ms is not None else "not run",
           runs["hybridized"]["wait_ms_mean"],
           runs["hybridized_workers"]["wait_ms_mean"], cfg["num_workers"],
           peak / 1e9))
    row["module_step_ms_within_epoch"] = mod_ms
    for name, p in gluon_stripped(net).items():
        if name.endswith(("running_mean", "running_var")):
            t = p.data()._data
            init = 0.0 if name.endswith("running_mean") else 1.0
            if not bool(torch.isfinite(t).all()) or bool((t == init).all()):
                raise AssertionError("moving statistic %s is not finite or "
                                     "did not move" % name)
    row["reload"] = gluon_reload(mt, net)
    data = mt.nd.array(x[:b], ctx=mt.gpu(0))
    if profile:
        label = mt.nd.array(y[:b], ctx=mt.gpu(0))

        def step():
            with mt.autograd.record():
                loss = loss_fn(net(data), label)
            loss.backward()
            trainer.step(b)

        net.hybridize()
        row["profile"] = profile_device(step, "Gluon hybridized step")
        dev = row["profile"]["device_ms"]
        compute = runs["hybridized"]["compute_ms_mean"]
        row["idle_share_estimate"] = 1.0 - dev / compute
        log("  idle share of the hybridized step's compute (host-clock "
            "mean %.2f ms less the profiled %.2f ms of device time), an "
            "estimate: %.1f%%" % (compute, dev,
                                  100.0 * row["idle_share_estimate"]))
    net.hybridize()
    row.update(eval_forward_gate(
        epi, lambda: net(data)._data, lambda: net.fused_sites,
        "Gluon evaluation forward (hybridized)"))
    del net, trainer, data
    torch.cuda.empty_cache()
    row["narrow_step"] = gluon_step_vs_cpu(mt, seed)
    return row


def gluon_reload(mt, net):
    """``save_params``, then a fresh resnet50_v2's ``load_params`` on
    gpu(0): every parameter bit for bit."""
    import tempfile
    tmp = tempfile.mkdtemp(prefix="chip_smoke_gluon_")
    try:
        fname = os.path.join(tmp, "resnet50_v2.params")
        net.save_params(fname)
        fresh = mt.gluon.model_zoo.vision.resnet50_v2(
            classes=RESNET["num_classes"])
        fresh.load_params(fname, ctx=mt.gpu(0))
        live, got = gluon_stripped(net), gluon_stripped(fresh)
        if sorted(live) != sorted(got):
            raise AssertionError("the reloaded net names other parameters")
        differ = sum(not torch.equal(live[k].data()._data,
                                     got[k].data()._data) for k in live)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log("  save_params -> a fresh net's load_params on gpu(0): %d "
        "parameters, %d not bit-identical" % (len(live), differ))
    if differ:
        raise AssertionError("%d reloaded parameters differ" % differ)
    return {"params": len(live), "differ": differ}


def _softmax64(o):
    o = o.astype(np.float64)
    e = np.exp(o - o.max(axis=1, keepdims=True))
    return e / e.sum(axis=1, keepdims=True)


def gluon_step_vs_cpu(mt, seed):
    """One SGD step (lr 0.1, no momentum) of the narrow ResNetV2 at
    resnet-8's size (B=32, 28x28) through autograd.record and
    Trainer.step, from the same weights: on gpu(0) hybridized and
    imperative, on cpu(), and in float64 on the CPU (the exact step).
    Each GPU step is held as phase 7 holds resnet-8: its probabilities
    within TRAIN_OUT_RTOL of the CPU's, its weights and moving statistics
    no farther from the float64 step than TRAIN_CPU_FACTOR times the CPU
    f32 step's. A hybridized control step with TF32 convolutions and
    GEMMs must fail a gate."""
    rng = np.random.RandomState(seed + 3)
    x = rng.rand(RESNET8_BATCH, *RESNET8["image_shape"]).astype(np.float32)
    y = rng.randint(0, GLUON_NARROW["classes"], RESNET8_BATCH).astype(
        np.float32)
    with mt.cpu():
        np.random.seed(seed + 3)
        net = gluon_narrow(mt)
        net.initialize(mt.init.Xavier(rnd_type="gaussian", factor_type="in",
                                      magnitude=2))
        net(mt.nd.array(x[:1]))
        start = {k: p.data().asnumpy() for k, p in
                 gluon_stripped(net).items()}
    flags = (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32)
    got = {}
    for run, ctx, hybrid, tf32, dtype in (
            ("gpu_hybridized", mt.gpu(0), True, False, "float32"),
            ("gpu_imperative", mt.gpu(0), False, False, "float32"),
            ("gpu_tf32", mt.gpu(0), True, True, "float32"),
            ("cpu", mt.cpu(), True, False, "float32"),
            ("float64", mt.cpu(), True, False, "float64")):
        torch.backends.cuda.matmul.allow_tf32 = tf32
        torch.backends.cudnn.allow_tf32 = tf32
        try:
            with ctx:
                net = gluon_narrow(mt)
                mt.convert.gluon_params_from_mxtpu(start, ctx, block=net)
                if dtype != "float32":
                    net.cast(dtype)
                net.hybridize(hybrid)
                trainer = mt.gluon.Trainer(net.collect_params(), "sgd",
                                           {"learning_rate": RESNET8_LR})
                loss_fn = mt.gluon.loss.SoftmaxCrossEntropyLoss()
                data = mt.nd.array(x, dtype=dtype)
                label = mt.nd.array(y, dtype=dtype)
                with mt.autograd.record():
                    out = net(data)
                    loss = loss_fn(out, label)
                loss.backward()
                trainer.step(RESNET8_BATCH)
                ps = gluon_stripped(net)
                got[run] = (
                    _softmax64(out.asnumpy()),
                    {k: p.data().asnumpy().astype(np.float64)
                     for k, p in ps.items() if p.grad_req != "null"},
                    {k: p.data().asnumpy().astype(np.float64)
                     for k, p in ps.items() if p.grad_req == "null"})
        finally:
            (torch.backends.cuda.matmul.allow_tf32,
             torch.backends.cudnn.allow_tf32) = flags
    _, exact_w, exact_a = got["float64"]
    return step_gate(got, exact_w, exact_a,
                     ("gpu_hybridized", "gpu_imperative"),
                     "narrow Gluon ResNetV2 SGD step (B=%d, lr %g)"
                     % (RESNET8_BATCH, RESNET8_LR))


def batch_breakdown(mt, sym_json, params, x, profile, label):
    """Where one largest-bucket batch's time goes on a gpu Predictor:
    input copy, forward (to a device sync) and the answer's device->host
    copy, by host clock; with ``profile`` also device time by kernel."""
    pred = mt.Predictor(sym_json, params, ctx=mt.gpu(0),
                        input_shapes={"data": x.shape})
    pred.forward(data=x)
    pred.get_outputs()
    reps = 3
    t_in = t_fwd = t_out = 0.0
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        pred.set_input("data", x)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        pred._executor.forward(is_train=False)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        pred.get_outputs()
        t3 = time.perf_counter()
        t_in += t1 - t0
        t_fwd += t2 - t1
        t_out += t3 - t2
    row = {"input_ms": t_in / reps * 1e3, "forward_ms": t_fwd / reps * 1e3,
           "to_host_ms": t_out / reps * 1e3}
    log("  %s bucket-%d batch on a gpu Predictor (mean of %d): input copy "
        "%.2f ms, forward %.2f ms, device->host %.2f ms"
        % (label, x.shape[0], reps, row["input_ms"], row["forward_ms"],
           row["to_host_ms"]))
    if profile:
        from torch.profiler import ProfilerActivity, profile as _prof
        with _prof(activities=[ProfilerActivity.CPU,
                               ProfilerActivity.CUDA]) as prof:
            pred._executor.forward(is_train=False)
            torch.cuda.synchronize()
        events = [e for e in prof.key_averages()
                  if getattr(e, "device_time_total", 0) > 0
                  and e.device_type.name == "CUDA"]
        total = sum(e.device_time_total for e in events)
        row["device_ms"] = total / 1e3
        row["by_kernel_ms"] = {e.key: e.device_time_total / 1e3
                               for e in events}
        log("  profiled forward: %.2f ms of device time in %d kernels"
            % (total / 1e3, len(events)))
        for e in sorted(events, key=lambda e: -e.device_time_total)[:10]:
            log("    %8.3f ms %5.1f%%  x%-4d %s"
                % (e.device_time_total / 1e3,
                   100.0 * e.device_time_total / max(total, 1e-9),
                   e.count, e.key[:90]))
    del pred
    torch.cuda.empty_cache()
    return row


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="also write the results as JSON here")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--profile", action="store_true",
                    help="also trace one largest-bucket forward of each "
                         "model and one training step of the LM, of "
                         "ResNet-50 through Module and through Gluon with "
                         "torch.profiler and print device time by kernel")
    ap.add_argument("--parent", metavar="CSRC", action="append", default=[],
                    help="the csrc directory of another tree (a parent "
                         "commit or a variant, unpacked outside the "
                         "commit): build its flash sources too and time its "
                         "kernels in turns with this tree's in phases 3 and "
                         "3c; repeatable")
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of %s to run after the "
                         "build (for iterating on one kernel); the kernels "
                         "line and the device line are printed only when "
                         "every phase ran" % ",".join(PHASES))
    args = ap.parse_args(argv)
    phases = [p for p in args.phases.split(",") if p]
    unknown = sorted(set(phases) - set(PHASES))
    if unknown:
        raise SystemExit("chip_smoke: unknown phases %s" % unknown)

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import mxtpu_torch as mt
    from mxtpu_torch.ops import attention as att
    from mxtpu_torch.ops import epilogue as epi
    card = card_line()
    log(card)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("torch %s, CUDA %s, %s, allow_tf32 matmul=%s cudnn=%s"
        % (torch.__version__, torch.version.cuda,
           torch.cuda.get_device_name(0),
           torch.backends.cuda.matmul.allow_tf32,
           torch.backends.cudnn.allow_tf32))

    # 2. build
    t0 = time.perf_counter()
    built = mt.build.build()
    log("[build] %s in %.1f s wall" % (
        {k: round(v, 1) for k, v in built.items()},
        time.perf_counter() - t0))
    for name, rec in mt.build.build_log.items():
        for inst, regs, st, ld in ptxas_instances(rec["ptxas"]):
            log("  %s: %s: %d registers, %d bytes spill stores, %d bytes "
                "spill loads" % (name, inst, regs, st, ld))
    hmma = check_flash_build(mt.build)
    parents = [ParentKernels(mt.build, csrc, i)  # all builds at once
               for i, csrc in enumerate(args.parent)]
    parents = [p.finish(att) for p in parents]

    results = {"card": card, "build_s": built, "hmma": hmma,
               "parents": [{"csrc": p.csrc, "ptxas": p.ptxas,
                            "hmma": p.hmma} for p in parents]}
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    # 3. kernel vs plain
    if "kernels" in phases:
        log("[kernels]")
        results["flash_timed"], worst = phase_kernels(att, gen, parents)
        results["worst_err"] = {str(k): v for k, v in worst.items()}
    if "epilogue" in phases:
        log("[epilogue]")
        results["epilogue_timed"] = phase_epilogue(epi, gen)
    if "backward" in phases:
        log("[backward]")
        results["backward_timed"], worst = phase_backward(att, gen,
                                                          parents)
        results["backward_worst_err"] = {str(k): v for k, v in worst.items()}
        results["backward_numerics"] = backward_numerics(att, gen)
    # 4. LM serving
    if "serving" in phases:
        log("[serving]")
        results["serving"] = phase_serving(mt, att, args.seed, card,
                                           profile=args.profile)
    # 5. ResNet-50 serving
    if "resnet" in phases:
        log("[resnet]")
        results["resnet"] = phase_resnet(mt, epi, args.seed, card,
                                         profile=args.profile)
    # 6. LM training
    if "training" in phases:
        log("[training]")
        results["training"] = phase_training(mt, att, args.seed, card,
                                             profile=args.profile)
    # 7. ResNet-50 training
    if "resnet_training" in phases:
        log("[resnet_training]")
        results["resnet_training"] = phase_resnet_training(
            mt, epi, args.seed, card, profile=args.profile)
    # 8. Gluon ResNet-50 training
    if "gluon" in phases:
        log("[gluon]")
        results["gluon"] = phase_gluon(mt, epi, args.seed, card,
                                       results.get("resnet_training"),
                                       profile=args.profile)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump(results, f, indent=1, default=str)
    if phases != list(PHASES):
        log("chip_smoke: phases %s only; no kernels line, no device line"
            % phases)
        return 1

    timed = results["flash_timed"]
    epi_timed = results["epilogue_timed"]
    served, resnet = results["serving"], results["resnet"]
    trained = results["training"]
    resnet_eval = results["resnet_training"]["eval_launches"]
    gluon_eval = results["gluon"]["eval_launches"]
    bwd_row = next(r for r in results["backward_timed"]
                   if r["dtype"] == "float32" and r["B"] == TRAIN["batch"])
    main_row = next(r for r in timed if r["dtype"] == "float32"
                    and r["B"] == max(BUCKETS))
    kernels = {"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "mxtpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mxtpu/ops/attention.py:92",
        "launches": served["launches"] + trained["fwd_launches"],
        "launches_by_path": {"lm_serving": served["launches"],
                             "lm_training": trained["fwd_launches"]},
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}, {
        "name": "bn_relu_epilogue", "route": "cuda",
        "source": "mxtpu_torch/csrc/bn_relu_epilogue.cu",
        "replaces": "mxtpu/ops/epilogue.py:30",
        "launches": resnet["launches"] + resnet_eval + gluon_eval,
        "launches_by_path": {"resnet_serving": resnet["launches"],
                             "resnet_training_eval": resnet_eval,
                             "gluon_eval": gluon_eval},
        "max_abs_err": epi_timed[0]["max_abs_err"],
        "ms": epi_timed[0]["ms"], "plain_ms": epi_timed[0]["plain_ms"],
        "bound_ms": epi_timed[0]["bound_ms"],
        "bound_by": epi_timed[0]["bound_by"], "library_ms": None}, {
        "name": "flash_attn_bwd", "route": "cuda",
        "source": "mxtpu_torch/csrc/flash_attn_bwd.cu",
        "replaces": "mxtpu/ops/attention.py:199",
        "launches": trained["bwd_launches"],
        "launches_by_path": {"lm_training": trained["bwd_launches"]},
        "max_abs_err": bwd_row["max_abs_err"],
        "scaled_err": bwd_row["scaled_err"],
        "ms": bwd_row["ms"], "plain_ms": bwd_row["plain_ms"],
        "bound_ms": bwd_row["bound_ms"], "bound_by": bwd_row["bound_by"],
        "library_ms": bwd_row["library_ms"]}]}
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
