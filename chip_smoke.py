#!/usr/bin/env python3
"""Drive the PyTorch port on one GPU and check it end to end.

    python3 chip_smoke.py

1. builds the CUDA kernels from ``src/repro_torch/kernels/csrc``;
2. holds each kernel against its plain PyTorch version on the card (bf16 and
   f32, qwen3 and qwen2 head layouts, ragged lengths);
3. serves qwen3-1.7b at full width and depth (random weights from a seeded
   ``torch.Generator``) through ``ServeEngine``: 12 requests, prompts of
   8-1500 tokens, 32 new tokens each, mixed priorities, 8 slots;
4. runs one prompt teacher-forced through the kernel path and the plain path
   and bounds the logit gap;
5. times each kernel at the serving shapes beside its bound, its plain
   version and one PyTorch library call, and prints the table as JSON.

The last line is ``{"ok": true, "device": {...}}``.  Without a CUDA device,
or without the repository's ``src/`` beside it, the script exits non-zero
and prints no result.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path
from unittest import mock

ROOT = Path(__file__).resolve().parent

# H100 SXM peaks (NVIDIA data sheet, dense): bf16 tensor cores, f32 CUDA
# cores, HBM3 bandwidth.
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
PEAK_BYTES = 3.35e12
SLEEP_CYCLES = 2_000_000   # ~1 ms of a spinning kernel ahead of each timed call

SERVE_ARCH = "qwen3-1.7b"
N_REQUESTS, MAX_NEW, MAX_BATCH, MAX_SEQ = 12, 32, 8, 2048
PROMPT_MIN, PROMPT_MAX = 8, 1500
TEACHER_PROMPT, TEACHER_STEPS, TEACHER_SLACK = 300, 16, 1.5
PROFILE_STEPS, PROFILE_PROMPT = 6, 512
TOL = {"float32": 2e-5, "bfloat16": 3e-2}   # as tests/test_kernels.py


class SmokeFailure(Exception):
    pass


def check(cond: bool, what: str) -> None:
    if not cond:
        raise SmokeFailure(what)


def max_err(out, want, tol):
    """(max |out - want|, within atol = rtol = tol elementwise)."""
    out, want = out.float(), want.float()
    err = (out - want).abs()
    return float(err.max()), bool((err <= tol + tol * want.abs()).all())


def time_ms(torch, fn, flush, reps: int = 25, warmup: int = 3) -> float:
    """Median device time of one call, CUDA events around each call.  The
    L2 cache is flushed before every call, as the serving loop finds it
    (each layer's weights and cache slice evict the last layer's), and the
    stream is held busy while the host enqueues the call, so that the
    events time the device and not the host's launch overhead."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(reps):
        flush.zero_()
        torch.cuda._sleep(SLEEP_CYCLES)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def bound_of(flops: float, nbytes: float, dtype: str):
    t_ops = flops / PEAK_FLOPS[dtype] * 1e3
    t_bytes = nbytes / PEAK_BYTES * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


# ---------------------------------------------------------------------------
# phase 2: kernels against their plain versions
# ---------------------------------------------------------------------------

ATTN_CASES = [  # (B, Sq, Sk, H, K, hd, causal)
    (1, 1, 1, 16, 8, 128, True),
    (1, 17, 17, 16, 8, 128, True),
    (2, 200, 200, 16, 8, 128, True),
    (1, 1000, 1000, 16, 8, 128, True),
    (1, 17, 200, 16, 8, 128, True),       # Sq != Sk: queries are the last 17
    (1, 200, 1000, 14, 2, 64, True),
    (1, 1000, 1000, 14, 2, 64, True),
    (2, 200, 17, 16, 8, 128, False),
    (1, 1000, 1000, 14, 2, 64, False),
]

DECODE_CASES = [  # (B, Smax, H, K, hd, lengths)
    (8, 2048, 16, 8, 128, [1, 7, 64, 65, 1000, 1500, 2047, 2048]),
    (3, 300, 14, 2, 64, [1, 150, 300]),
    (2, 512, 16, 8, 128, 300),            # one scalar length for the batch
]


def check_kernels(torch, dev):
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(0)

    def randn(shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    for dtype_name in ("float32", "bfloat16"):
        dtype, tol = getattr(torch, dtype_name), TOL[dtype_name]
        for B, Sq, Sk, H, K, hd, causal in ATTN_CASES:
            q = randn((B, Sq, H, hd), dtype)
            k, v = randn((B, Sk, K, hd), dtype), randn((B, Sk, K, hd), dtype)
            err, ok = max_err(flash_attention(q, k, v, causal=causal),
                              ref.attention_ref(q, k, v, causal=causal), tol)
            torch.cuda.synchronize()
            print(f"  flash_attention {dtype_name} B={B} Sq={Sq} Sk={Sk} H={H} K={K} "
                  f"hd={hd} causal={causal}: max_abs_err={err:.3e} (tol {tol})")
            check(ok, f"flash_attention disagrees with attention_ref: {err}")
        for B, Smax, H, K, hd, lengths in DECODE_CASES:
            q = randn((B, 1, H, hd), dtype)
            # a layer of a stacked (L, B, Smax, K, hd) cache, read in place
            ck = randn((2, B, Smax, K, hd), dtype)[1]
            cv = randn((2, B, Smax, K, hd), dtype)[1]
            length = (torch.tensor(lengths, dtype=torch.int32, device=dev)
                      if isinstance(lengths, list) else lengths)
            err, ok = max_err(flash_decode(q, ck, cv, length),
                              ref.decode_attention_ref(q, ck, cv, length), tol)
            torch.cuda.synchronize()
            print(f"  flash_decode {dtype_name} B={B} Smax={Smax} H={H} K={K} hd={hd} "
                  f"lengths={lengths}: max_abs_err={err:.3e} (tol {tol})")
            check(ok, f"flash_decode disagrees with decode_attention_ref: {err}")


# ---------------------------------------------------------------------------
# phase 3: serve qwen3-1.7b
# ---------------------------------------------------------------------------

def serve(torch, np, dev, cfg, params):
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_attention
    from repro_torch.serve.engine import ServeEngine

    # warm-up on a small engine: cuBLAS handles, allocator, first launches
    warm = ServeEngine(cfg, params, max_batch=1, max_seq=64, device=dev)
    warm.submit([1, 2, 3, 4], max_new=3)
    warm.run()
    del warm

    rng = np.random.default_rng(0)
    lengths = rng.integers(PROMPT_MIN, PROMPT_MAX + 1, N_REQUESTS)
    priorities = rng.integers(0, 3, N_REQUESTS)
    eng = ServeEngine(cfg, params, max_batch=MAX_BATCH, max_seq=MAX_SEQ, device=dev)
    reqs = [eng.submit(rng.integers(0, cfg.vocab, n).tolist(), max_new=MAX_NEW,
                       priority=int(p)) for n, p in zip(lengths, priorities)]
    flash_attention.launches = 0
    flash_decode.launches = 0
    t0 = time.perf_counter()
    done = eng.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = {"flash_attention": flash_attention.launches,
                "flash_decode": flash_decode.launches}

    check(len(done) == N_REQUESTS and all(r.done for r in reqs),
          f"{len(done)} of {N_REQUESTS} requests finished")
    check(all(len(r.out) == MAX_NEW for r in reqs), "a request stopped short")
    check(all(0 <= t < cfg.vocab for r in reqs for t in r.out), "token out of range")
    for name, n in launches.items():
        check(n > 0, f"{name} was not launched on the serving path")
    check(launches["flash_attention"] == N_REQUESTS * cfg.n_layers,
          f"flash_attention launches {launches['flash_attention']} != "
          f"{N_REQUESTS} prefills x {cfg.n_layers} layers")
    check(launches["flash_decode"] == eng.decode_steps * cfg.n_layers,
          f"flash_decode launches {launches['flash_decode']} != "
          f"{eng.decode_steps} steps x {cfg.n_layers} layers")

    ttft = sorted(r.first_token_at - r.submitted_at for r in reqs)
    decode_tokens = eng.tokens_out - N_REQUESTS
    print(f"  requests={len(done)} prompt_tokens={int(lengths.sum())} "
          f"tokens_out={eng.tokens_out} decode_steps={eng.decode_steps} "
          f"wall_s={wall:.3f}")
    print(f"  ttft_s p50={statistics.median(ttft):.4f} max={ttft[-1]:.4f} "
          f"(queueing for a slot included)")
    print(f"  prefill_s={eng.prefill_s:.3f} "
          f"prefill_tok_s={lengths.sum() / eng.prefill_s:.1f} "
          f"decode_s={eng.decode_s:.3f} decode_tok_s={decode_tokens / eng.decode_s:.1f} "
          f"ms_per_decode_step={1e3 * eng.decode_s / eng.decode_steps:.2f}")
    print(f"  launches: {launches}")
    profile_decode(torch, np, cfg, eng)
    return launches, [int(n) for n in lengths]


def profile_decode(torch, np, cfg, eng):
    """Where a decode step's time goes, 8 slots busy at 512-token prompts:
    host time per step, then device time per step by kernel from a
    torch.profiler window (sum of kernel durations; one stream, so they do
    not overlap), and the device's idle share of the unprofiled step."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    rng = np.random.default_rng(2)
    for _ in range(MAX_BATCH):
        eng.submit(rng.integers(0, cfg.vocab, PROFILE_PROMPT).tolist(), max_new=16)
    eng._admit()
    eng.step()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(PROFILE_STEPS):
        eng.step()
    torch.cuda.synchronize()
    step_ms = 1e3 * (time.perf_counter() - t0) / PROFILE_STEPS
    by_name = {}
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(PROFILE_STEPS):
                eng.step()
            torch.cuda.synchronize()
            wall_ms = 1e3 * (time.perf_counter() - t0)
        for e in prof.events():
            if e.device_type == DeviceType.CUDA:
                by_name[e.name] = by_name.get(e.name, 0.0) + e.time_range.elapsed_us() / 1e3
    except RuntimeError as exc:       # a diagnostic: the profiler may be unavailable
        print(f"  torch.profiler failed ({exc}); device time not measured")
    busy_ms = sum(by_name.values())
    busy_step = busy_ms / PROFILE_STEPS
    print(f"  decode step (8 slots, ~{PROFILE_PROMPT + 8} positions): {step_ms:.2f} ms host "
          f"clock; device busy {busy_step:.2f} ms/step, idle share {1 - busy_step / step_ms:.3f}"
          f" (profiled window {wall_ms / PROFILE_STEPS:.2f} ms/step)" if busy_ms else
          f"  decode step: {step_ms:.2f} ms host clock; profiler saw no device time")
    for name, ms in sorted(by_name.items(), key=lambda kv: -kv[1])[:10]:
        print(f"    {ms / PROFILE_STEPS:8.3f} ms/step  {name[:100]}")
    eng.run()


# ---------------------------------------------------------------------------
# phase 4: teacher-forced logits, kernel path vs plain path
# ---------------------------------------------------------------------------

def run_path(torch, cfg, params, prompt, feed=None):
    """Prefill + TEACHER_STEPS decode steps; greedy unless ``feed`` gives
    the tokens.  Returns (f32 logits (steps+1, V), the tokens fed)."""
    from repro_torch.models import transformer as T
    dev = params.embed.table.device
    toks = torch.tensor([prompt], dtype=torch.int32, device=dev)
    logits, cache = T.prefill(cfg, params, toks, max_seq=len(prompt) + TEACHER_STEPS)
    rows, fed = [logits[0, -1].float()], []
    for i in range(TEACHER_STEPS):
        nxt = int(rows[-1].argmax()) if feed is None else feed[i]
        fed.append(nxt)
        step = torch.tensor([[nxt]], dtype=torch.int32, device=dev)
        logits, cache = T.decode_step(cfg, params, cache, step)
        rows.append(logits[0, -1].float())
    return torch.stack(rows), fed


def teacher_forced(torch, np, cfg, params):
    from repro_torch.kernels import ops, ref

    prompt = np.random.default_rng(1).integers(0, cfg.vocab, TEACHER_PROMPT).tolist()
    kern, fed = run_path(torch, cfg, params, prompt)
    with mock.patch.object(ops, "attention", ref.attention_ref), \
            mock.patch.object(ops, "decode_attention", ref.decode_attention_ref):
        plain, _ = run_path(torch, cfg, params, prompt, feed=fed)
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = copy.deepcopy(params).float()
        plain32, _ = run_path(torch, cfg32, params32, prompt, feed=fed)
        del params32
    check(bool(torch.isfinite(kern).all()), "non-finite logits on the kernel path")
    gap = (kern - plain).abs()
    kern_err = (kern - plain32).abs()
    plain_err = (plain - plain32).abs()
    print(f"  kernel vs plain (both bf16): max|dlogit|={float(gap.max()):.4e} "
          f"mean={float(gap.mean()):.4e}")
    print(f"  kernel bf16 vs plain f32: max|dlogit|={float(kern_err.max()):.4e} "
          f"mean={float(kern_err.mean()):.4e}")
    print(f"  plain bf16 vs plain f32: max|dlogit|={float(plain_err.max()):.4e} "
          f"mean={float(plain_err.mean()):.4e}  |logit| mean={float(plain32.abs().mean()):.4e}")
    # Bound: against the f32 plain path, the bf16 kernel path may err at
    # most TEACHER_SLACK times as much as the bf16 plain path does.  (Any
    # bf16 rounding grows through 28 random layers to about the same size,
    # so the kernel-vs-plain gap itself is as large as the bf16 error; a
    # wrong kernel moves the logits by their own size, ~0.7 on average.)
    check(float(kern_err.max()) <= TEACHER_SLACK * float(plain_err.max())
          and float(kern_err.mean()) <= TEACHER_SLACK * float(plain_err.mean()),
          f"kernel path errs more than {TEACHER_SLACK}x the bf16 plain path")


# ---------------------------------------------------------------------------
# phase 5: the kernel table at serving shapes
# ---------------------------------------------------------------------------

def kernel_table(torch, dev, launches, prompt_lengths):
    import torch.nn.functional as F
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    from repro_torch.kernels.flash_attention import flash_attention

    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    bf16 = torch.bfloat16
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)   # 256 MB > L2
    rows = []

    def randn(shape):
        return torch.randn(shape, generator=gen, device=dev).to(bf16)

    def sdpa_ms(fn):
        try:
            return time_ms(torch, fn, flush)
        except (TypeError, RuntimeError) as exc:   # e.g. a torch without enable_gqa
            print(f"  library call unavailable: {exc}")
            return None

    # prefill of one qwen3-1.7b layer at S = 1024
    H, K, hd, S = 16, 8, 128, 1024
    q, k, v = randn((1, S, H, hd)), randn((1, S, K, hd)), randn((1, S, K, hd))
    err, ok = max_err(flash_attention(q, k, v), ref.attention_ref(q, k, v), TOL["bfloat16"])
    check(ok, "flash_attention disagrees at the timed shape")
    qt, kt, vt = (t.transpose(1, 2) for t in (q, k, v))
    pairs = S * (S + 1) // 2                      # causal (query, key) pairs
    flops = 4.0 * H * hd * pairs
    nbytes = 2.0 * (q.numel() + k.numel() + v.numel() + q.numel())
    bound, by = bound_of(flops, nbytes, "bfloat16")
    rows.append({
        "name": "flash_attention", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention.py:94",
        "shape": f"qwen3-1.7b prefill layer: B=1 S={S} H={H} K={K} hd={hd} bf16 causal",
        "launches": launches["flash_attention"], "max_abs_err": err,
        "ms": time_ms(torch, lambda: flash_attention(q, k, v), flush),
        "plain_ms": time_ms(torch, lambda: ref.attention_ref(q, k, v), flush),
        "bound_ms": bound, "bound_by": by,
        "library_ms": sdpa_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, is_causal=True, enable_gqa=True)),
    })

    # decode of one qwen3-1.7b layer: 8 slots, the serving run's first eight
    # prompts half-way through their 32 new tokens
    B, Smax = MAX_BATCH, MAX_SEQ
    lens = [n + MAX_NEW // 2 for n in prompt_lengths[:B]]
    q = randn((B, 1, H, hd))
    ck, cv = randn((2, B, Smax, K, hd))[1], randn((2, B, Smax, K, hd))[1]
    length = torch.tensor(lens, dtype=torch.int32, device=dev)
    err, ok = max_err(flash_decode(q, ck, cv, length),
                      ref.decode_attention_ref(q, ck, cv, length), TOL["bfloat16"])
    check(ok, "flash_decode disagrees at the timed shape")
    mask = (torch.arange(Smax, device=dev)[None, :] < length[:, None])[:, None, None, :]
    qt, kt, vt = q.transpose(1, 2), ck.transpose(1, 2), cv.transpose(1, 2)
    flops = 4.0 * H * hd * sum(lens)
    nbytes = 2.0 * (2 * K * hd * sum(lens) + 2 * q.numel()) + 4 * B
    bound, by = bound_of(flops, nbytes, "bfloat16")
    rows.append({
        "name": "flash_decode", "route": "cuda",
        "source": "src/repro_torch/kernels/csrc/decode_attention.cu",
        "replaces": "src/repro/kernels/decode_attention.py:85",
        "shape": f"qwen3-1.7b decode layer: B={B} Smax={Smax} H={H} K={K} hd={hd} bf16 "
                 f"lengths={lens}",
        "launches": launches["flash_decode"], "max_abs_err": err,
        "ms": time_ms(torch, lambda: flash_decode(q, ck, cv, length), flush),
        "plain_ms": time_ms(torch, lambda: ref.decode_attention_ref(q, ck, cv, length),
                            flush),
        "bound_ms": bound, "bound_by": by,
        "library_ms": sdpa_ms(lambda: F.scaled_dot_product_attention(
            qt, kt, vt, attn_mask=mask, enable_gqa=True)),
    })
    for r in rows:
        print(f"  {r['name']}: {r['ms']:.4f} ms (bound {r['bound_ms']:.4f} ms by "
              f"{r['bound_by']}, plain {r['plain_ms']:.4f} ms, library {r['library_ms']} ms) "
              f"at {r['shape']}")
    return rows


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's smoke needs one GPU", file=sys.stderr)
        return 1
    if not (ROOT / "src" / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {Path(__file__).name}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    import numpy as np
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import _build
    from repro_torch.models import bundle_for, param_count

    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip().splitlines()
    print(smi[0] if smi else "nvidia-smi: no output")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f"torch {torch.__version__} cuda {torch.version.cuda}; "
          f"device {torch.cuda.get_device_name(0)}; "
          f"torch.backends.cuda.matmul.allow_tf32={torch.backends.cuda.matmul.allow_tf32}")

    try:
        print("phase 1: build")
        t0 = time.perf_counter()
        so, log = _build.build()
        print(f"  built {so.name} in {time.perf_counter() - t0:.1f} s")
        for line in log.splitlines():
            if "registers" in line or "spill" in line or "warning" in line:
                print(f"  {line.strip()}")

        print("phase 2: kernels vs plain versions")
        check_kernels(torch, dev)

        print(f"phase 3: serve {SERVE_ARCH}")
        cfg = get_config(SERVE_ARCH)
        t0 = time.perf_counter()
        params = bundle_for(cfg).init(cfg, 0, device=dev)
        torch.cuda.synchronize()
        print(f"  {param_count(cfg) / 1e9:.3f} B params, {cfg.n_layers} layers, "
              f"d_model {cfg.d_model}, init {time.perf_counter() - t0:.1f} s")
        launches, prompt_lengths = serve(torch, np, dev, cfg, params)
        print(f"  peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB")

        print("phase 4: teacher-forced logits, kernel path vs plain path")
        teacher_forced(torch, np, cfg, params)
        del params

        print("phase 5: kernel times at serving shapes")
        rows = kernel_table(torch, dev, launches, prompt_lengths)
    except SmokeFailure as exc:
        print(f"chip_smoke: FAILED: {exc}", file=sys.stderr)
        return 1

    print(json.dumps({"kernels": rows}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu",
                                             "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
