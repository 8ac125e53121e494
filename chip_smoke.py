"""Drive the PyTorch/CUDA port's serving path on one NVIDIA GPU.

    python3 chip_smoke.py [--out results.json] [--seed N] [--profile]

Phases (any failure raises and exits non-zero):

1. Device: require CUDA; print the card's name and power limit.
2. Build every hand-written kernel of ``mxtpu_torch/csrc`` with nvcc
   (one process per source, started together) and print the seconds.
3. Kernel vs plain: each kernel against its plain PyTorch version on the
   card, at the serving path's shapes and at edge cases, in float32
   (max abs err <= 2e-4) and bfloat16 (<= 2e-2); then CUDA-event times
   of the kernel, the plain version and the library call that computes
   the same function (timed as a yardstick only; the port never calls
   it), beside the least time the card could take (bound_ms).
4. Serving: the transformer LM at GPT-2-small widths with seeded random
   weights, served by ``ServingSession`` on gpu(0) with buckets (1, 4):
   8 requests of 1024 tokens from 4 client threads. Checks that every
   probability row is finite and sums to 1, that the flash kernel ran
   exactly once per layer per dispatched batch, and that one answer
   matches a ``Predictor`` on cpu() (the plain versions).
5. Prints the kernels' JSON line, then the device line last.
"""
from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import threading
import time

import numpy as np
import torch

# published H100 SXM peaks (NVIDIA data sheet, dense): bytes/s of HBM3 and
# the operations/s of each type the kernels compute in
HBM_BYTES_PER_S = 3.35e12
PEAK_OPS_PER_S = {torch.float32: 67e12, torch.bfloat16: 989e12}

LM = dict(vocab_size=50257, seq_len=1024, num_layers=12, num_heads=12,
          d_model=768, d_ff=3072)  # GPT-2 small (Radford et al. 2019)
BUCKETS = (1, 4)
N_REQUESTS = 8
N_CLIENTS = 4
TOL = {torch.float32: 2e-4, torch.bfloat16: 2e-2}


def log(*a):
    print(*a, flush=True)


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--id=0", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip()


def cuda_ms(fn, iters, warmup=3):
    """Mean device time of fn() over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def attention_bound_ms(b, h, t, s, d, causal, dtype):
    """Least time for the attention forward: live (row, key) pairs times
    4*d flops against the type's peak, or q, k, v read and o written once
    against the HBM rate, whichever is larger."""
    if causal:
        pairs = sum(min(r + 1, s) for r in range(t))
    else:
        pairs = t * s
    flops = 4.0 * d * pairs * b * h
    nbytes = (2 * b * h * t * d + 2 * b * h * s * d) * \
        torch.empty((), dtype=dtype).element_size()
    ops_ms = flops / PEAK_OPS_PER_S[dtype] * 1e3
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    return max(ops_ms, bytes_ms), ("operations" if ops_ms >= bytes_ms
                                   else "bytes")


def phase_kernels(att, gen):
    """Flash kernel vs its plain version; returns the timed main-shape row."""
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

    timed = {}
    for b in BUCKETS:
        h, t, d = 12, 1024, 64
        q, k, v = (torch.randn(b, h, t, d, device="cuda", generator=gen)
                   for _ in range(3))
        got = att.flash_attention(q, k, v, causal=True)
        want = att.flash_attention_reference(q, k, v, causal=True)
        err = (got - want).abs().max().item()
        ms = cuda_ms(lambda: att.flash_attention(q, k, v, causal=True), 50)
        plain_ms = cuda_ms(
            lambda: att.flash_attention_reference(q, k, v, causal=True), 10)
        lib_ms = cuda_ms(lambda: F.scaled_dot_product_attention(
            q, k, v, is_causal=True), 50)
        bound_ms, bound_by = attention_bound_ms(b, h, t, t, d, True,
                                                torch.float32)
        log("  flash f32 causal B=%d H=%d T=S=%d D=%d: kernel %.4f ms, "
            "plain %.4f ms, sdpa %.4f ms, bound %.4f ms (%s), err %.3e"
            % (b, h, t, d, ms, plain_ms, lib_ms, bound_ms, bound_by, err))
        timed[b] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms,
                        library_ms=lib_ms, bound_ms=bound_ms,
                        bound_by=bound_by)
    return timed, worst


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

    breakdown = batch_breakdown(mt, sym_json, params, requests, profile)
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


def batch_breakdown(mt, sym_json, params, requests, profile):
    """Where a bucket-4 batch's time goes on a gpu Predictor: input
    copy, forward (to a device sync) and the answer's device->host copy,
    by host clock; with ``profile`` also device time by kernel name."""
    b = max(BUCKETS)
    pred = mt.Predictor(sym_json, params, ctx=mt.gpu(0),
                        input_shapes={"data": (b, LM["seq_len"])})
    x = np.concatenate(requests[:b])
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
    log("  bucket-%d batch on a gpu Predictor (mean of %d): input copy "
        "%.2f ms, forward %.2f ms, device->host %.2f ms"
        % (b, reps, row["input_ms"], row["forward_ms"], row["to_host_ms"]))
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
        row["by_kernel_ms"] = {}
        log("  profiled forward: %.2f ms of device time in %d kernels"
            % (total / 1e3, len(events)))
        for e in sorted(events, key=lambda e: -e.device_time_total)[:8]:
            row["by_kernel_ms"][e.key[:80]] = e.device_time_total / 1e3
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
                    help="also trace one bucket-4 forward with "
                         "torch.profiler and print device time by kernel")
    args = ap.parse_args(argv)

    # 1. device
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device")
    import mxtpu_torch as mt
    from mxtpu_torch.ops import attention as att
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
        for line in rec["ptxas"].splitlines():
            if "registers" in line or "spill" in line:
                log("  %s: %s" % (name, line.strip()))

    # 3. kernel vs plain
    log("[kernels]")
    gen = torch.Generator(device="cuda").manual_seed(args.seed)
    timed, worst = phase_kernels(att, gen)

    # 4. serving
    log("[serving]")
    served = phase_serving(mt, att, args.seed, card, profile=args.profile)

    main_row = timed[max(BUCKETS)]
    kernels = {"kernels": [{
        "name": "flash_attn_fwd", "route": "cuda",
        "source": "mxtpu_torch/csrc/flash_attn_fwd.cu",
        "replaces": "mxtpu/ops/attention.py:92",
        "launches": served["launches"],
        "max_abs_err": main_row["max_abs_err"],
        "ms": main_row["ms"], "plain_ms": main_row["plain_ms"],
        "bound_ms": main_row["bound_ms"], "bound_by": main_row["bound_by"],
        "library_ms": main_row["library_ms"]}]}
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)),
                    exist_ok=True)
        with open(args.out, "w") as f:
            json.dump({"card": card, "kernels": kernels["kernels"],
                       "timed_by_batch": timed,
                       "worst_err": {str(k): v for k, v in worst.items()},
                       "serving": served, "build_s": built}, f, indent=1)
    log(json.dumps(kernels))
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
