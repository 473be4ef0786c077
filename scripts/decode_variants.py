#!/usr/bin/env python3
"""Build variants of the flash-decode kernel from patched copies of
``src/repro_torch/kernels/csrc/decode_attention.cu`` and hold them against
the kernel as it is, on one GPU.  The checked-in source is never changed:
each variant is compiled from a copy under ``kernels/_build/variants/``.

    python3 scripts/decode_variants.py faults
    python3 scripts/decode_variants.py evict-first
    python3 scripts/decode_variants.py splits

``faults`` plants faults in the bf16 kernel (a wrong K/V tile, a ring
refill one tile behind, a tile dropped at each span's end, the last span
left out of the cluster merge) and prints, for every decode case of
``chip_smoke.py`` phase 2, the two readings that phase checks: the largest
elementwise error against ``decode_attention_ref`` (limit atol = rtol =
3e-2) and the largest error of one (slot, query head) row relative to
that row's size (``chip_smoke.DECODE_REL_TOL``).  The sound kernel's
readings come first, in both dtypes; a limit is useful where it lies
above them and below the faults'.

``evict-first`` builds the kernel with an L2 evict-first hint on its K/V
copies and compares it with the kernel as it is inside the served decode
steps of ``chip_smoke.py`` phases 3, 5 and 6 (qwen3-1.7b through
``ServeEngine``, zamba2-2.7b and qwen3-moe-30b-a3b through the serve
steps): the flash-decode kernels' device time per step from
``torch.profiler``, alternating the two libraries over several windows.

``splits`` compares, the same way, ``decode_splits`` with 1, 2 and 4
blocks per (slot, KV head), and also times the kernel alone at phase 7's
three decode shapes under phase 7's L2 flush with each.
"""

from __future__ import annotations

import argparse
import ctypes
import functools
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (stdlib only at import)

ROUNDS = 3   # profiler windows per setup, alternating

# (name, [(text in decode_attention.cu, replacement), ...])
FAULTS = [
    ("second tile of each span reads the first tile's K/V",
     [("const int pos = t * TK + r;", "const int pos = (t == t0 + 1 ? t0 : t) * TK + r;")]),
    ("ring refilled one tile behind (from the third tile of a span on)",
     [("load_tile(t0 + i + STAGES - 1, (i + STAGES - 1) % STAGES);",
       "load_tile(t0 + i + STAGES - 2, (i + STAGES - 1) % STAGES);")]),
    ("each span but the last drops its last tile",
     [("span_begin(c + 1, T, spans) - t0,",
       "max(1, span_begin(c + 1, T, spans) - t0 - (c + 1 < spans)),")]),
    ("cluster merge leaves out the last span",
     [("for (int r = 0; r < spans; ++r)", "for (int r = 0; r < spans - 1; ++r)")]),
]

EVICT_FIRST = [(
    """  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\\n" ::"r"(dst), "l"(src),
               "r"(valid ? 16 : 0)
               : "memory");""",
    """  uint64_t policy;
  asm("createpolicy.fractional.L2::evict_first.b64 %0, 1.0;\\n" : "=l"(policy));
  asm volatile("cp.async.cg.shared.global.L2::cache_hint [%0], [%1], 16, %2, %3;\\n"
               ::"r"(dst), "l"(src), "r"(valid ? 16 : 0), "l"(policy)
               : "memory");""")]


def build_variants(variants):
    """{name: patches} -> {name: loaded library}; all compiled at once."""
    from repro_torch.kernels import _build
    csrc = _build._CSRC
    source = (csrc / "decode_attention.cu").read_text()
    top = _build.BUILD_DIR / "variants"
    shutil.rmtree(top, ignore_errors=True)
    procs = {}
    for i, (name, patches) in enumerate(variants.items()):
        text = source
        for old, new in patches:
            if text.count(old) < 1:
                raise SystemExit(f"variant {name!r}: {old!r} not in decode_attention.cu")
            text = text.replace(old, new)
        d = top / f"v{i}"
        d.mkdir(parents=True)
        (d / "decode_attention.cu").write_text(text)
        so = d / "libdecode.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-I", str(csrc), "-shared",
             str(d / "decode_attention.cu"), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name!r}:\n{out}")
        for line in smoke.ptxas_summary(out):
            if "mma" in line:
                print(f"  [{name}] {line}")
        lib = ctypes.CDLL(str(so))
        ptr, i32, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
        lib.flash_decode_fwd.argtypes = [ptr, ptr, ptr, ptr, i32, ptr] + [i32] * 8 + [
            i64p, ctypes.c_float, ptr, ptr]
        lib.flash_decode_fwd.restype = i32
        libs[name] = lib
    return libs


def use(lib) -> None:
    """Route the flash_decode wrapper to ``lib``."""
    from repro_torch.kernels import decode_attention
    decode_attention.library = lambda: lib


def faults(torch, dev) -> None:
    from repro_torch.kernels import ref
    from repro_torch.kernels.decode_attention import flash_decode
    libs = build_variants({"sound": [], **dict(FAULTS)})

    def case_inputs(i, B, Smax, H, K, hd, lengths, dtype):
        gen = torch.Generator(device=dev)
        gen.manual_seed(100 + i)

        def randn(shape):
            return torch.randn(shape, generator=gen, device=dev).to(dtype)
        q = randn((B, 1, H, hd))
        ck, cv = randn((2, B, Smax, K, hd))[1], randn((2, B, Smax, K, hd))[1]
        length = (torch.tensor(lengths, dtype=torch.int32, device=dev)
                  if isinstance(lengths, list) else lengths)
        return q, ck, cv, length

    for name, lib in libs.items():
        use(lib)
        for dtype_name in ("float32", "bfloat16") if name == "sound" else ("bfloat16",):
            dtype = getattr(torch, dtype_name)
            tol, rel_tol = smoke.TOL[dtype_name], smoke.DECODE_REL_TOL[dtype_name]
            worst_abs = worst_rel = 0.0
            caught_abs = caught_rel = 0
            for i, (B, Smax, H, K, hd, lengths) in enumerate(smoke.DECODE_CASES):
                q, ck, cv, length = case_inputs(i, B, Smax, H, K, hd, lengths, dtype)
                out = flash_decode(q, ck, cv, length)
                want = ref.decode_attention_ref(q, ck, cv, length)
                err, ok = smoke.max_err(out, want, tol)
                rel = smoke.row_rel_err(out, want)
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
                caught_abs += not ok
                caught_rel += not rel <= rel_tol
                print(f"  [{name}] {dtype_name} case {i} B={B} Smax={Smax} H={H} K={K} "
                      f"hd={hd}: max_abs_err={err:.3e} row_rel_err={rel:.3e}")
            print(f"[{name}] {dtype_name}: largest max_abs_err {worst_abs:.3e}, largest "
                  f"row_rel_err {worst_rel:.3e}; cases failing atol=rtol={tol}: {caught_abs}, "
                  f"failing row_rel_err <= {rel_tol}: {caught_rel} of "
                  f"{len(smoke.DECODE_CASES)}")


def decode_ms(torch, step, n_steps):
    """(flash-decode device ms, all device ms) per call of ``step`` over a
    torch.profiler window of ``n_steps`` calls."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n_steps):
            step()
        torch.cuda.synchronize()
    dec = busy = 0.0
    for e in prof.events():
        if e.device_type == DeviceType.CUDA:
            ms = e.time_range.elapsed_us() / 1e3
            busy += ms
            dec += ms if "flash_decode" in e.name else 0.0
    return dec / n_steps, busy / n_steps


def compare(torch, label, step, setups) -> None:
    """Device time per ``step`` under each of ``setups`` ({name: callable
    that sets the kernel up}), in ROUNDS alternating profiler windows."""
    for setup in setups.values():          # warm each
        setup()
        step()
    got = {name: [] for name in setups}
    for _ in range(ROUNDS):
        for name, setup in setups.items():
            setup()
            got[name].append(decode_ms(torch, step, smoke.PROFILE_STEPS))
    for name, runs in got.items():
        print(f"  {label} [{name}]: flash_decode "
              f"{[round(1e3 * d, 2) for d, _ in runs]} us/step (median "
              f"{1e3 * statistics.median(d for d, _ in runs):.2f}), device busy "
              f"{[round(b, 3) for _, b in runs]} ms/step")


def served_steps(torch, np, dev, n_steps):
    """Yield (label, step) for the decode step of each served model of
    chip_smoke.py phases 3, 5 and 6, with room for ``n_steps`` more steps;
    each model's weights are freed before the next is drawn."""
    from repro_torch.configs.base import get_config
    from repro_torch.models import bundle_for
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train.step import make_prefill, make_serve_step

    cfg = get_config(smoke.SERVE_ARCH)
    params = bundle_for(cfg).init(cfg, 0, device=dev)
    eng = ServeEngine(cfg, params, max_batch=smoke.MAX_BATCH, max_seq=smoke.MAX_SEQ,
                      device=dev)
    rng = np.random.default_rng(2)
    for _ in range(smoke.MAX_BATCH):
        eng.submit(rng.integers(0, cfg.vocab, smoke.PROFILE_PROMPT).tolist(),
                   max_new=n_steps + 2)
    eng._admit()
    eng.step()
    yield (f"{smoke.SERVE_ARCH} engine decode step, {smoke.MAX_BATCH} slots at "
           f"~{smoke.PROFILE_PROMPT} positions", eng.step)
    del eng, params
    torch.cuda.empty_cache()

    for arch, batch, prompt_len, max_seq, _ in (smoke.HYBRID_RUN, smoke.MOE_RUN):
        cfg = get_config(arch)
        params = bundle_for(cfg).init(cfg, 0, device=dev)
        prefill, serve_step = make_prefill(cfg), make_serve_step(cfg)
        toks = torch.tensor(np.random.default_rng(3).integers(0, cfg.vocab,
                                                              (batch, prompt_len)),
                            dtype=torch.int32, device=dev)
        logits, cache = prefill(params, {"tokens": toks}, max_seq=max_seq)
        state = {"cache": cache, "nxt": logits[:, -1].argmax(-1, keepdim=True).to(torch.int32)}
        del logits, cache

        def one_step():
            out, state["cache"] = serve_step(params, state["cache"], state["nxt"])
            state["nxt"] = out[:, -1].argmax(-1, keepdim=True).to(torch.int32)

        yield f"{arch} decode step, {batch} slots from {prompt_len} positions", one_step
        del params, state
        torch.cuda.empty_cache()


def evict_first(torch, np, dev) -> None:
    libs = build_variants({"as is": [], "evict-first": EVICT_FIRST})
    setups = {name: functools.partial(use, lib) for name, lib in libs.items()}
    n_steps = 2 * (ROUNDS + 1) * smoke.PROFILE_STEPS
    for label, step in served_steps(torch, np, dev, n_steps):
        compare(torch, label, step, setups)


def splits(torch, np, dev) -> None:
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import decode_attention
    from repro_torch.kernels.decode_attention import TILE, flash_decode

    def fixed(k):
        decode_attention.decode_splits = lambda b, kv, smax, sms: max(1, min(k, -(-smax // TILE)))

    setups = {f"{k} a pair": functools.partial(fixed, k) for k in (1, 2, 4)}
    rule = decode_attention.decode_splits

    # the kernel alone at phase 7's decode shapes, phase 7's flush
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    flush = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    prompts = np.random.default_rng(0).integers(smoke.PROMPT_MIN, smoke.PROMPT_MAX + 1,
                                                smoke.N_REQUESTS)
    # (arch, batch, Smax, lengths) as chip_smoke.kernel_table builds them
    shapes = [(smoke.SERVE_ARCH, smoke.MAX_BATCH, smoke.MAX_SEQ,
               [int(n) + smoke.MAX_NEW // 2 for n in prompts[:smoke.MAX_BATCH]])]
    for arch, B, S, max_seq, steps in (smoke.HYBRID_RUN, smoke.MOE_RUN):
        shapes.append((arch, B, max_seq, [S + steps // 2] * B))
    for name, B, Smax, lens in shapes:
        cfg = get_config(name)
        H, K, hd = cfg.n_heads, cfg.n_kv_heads, cfg.hd
        q = torch.randn((B, 1, H, hd), generator=gen, device=dev).to(torch.bfloat16)
        ck, cv = (torch.randn((2, B, Smax, K, hd), generator=gen, device=dev)
                  .to(torch.bfloat16)[1] for _ in range(2))
        length = torch.tensor(lens, dtype=torch.int32, device=dev)
        times = {}
        for label, setup in setups.items():
            setup()
            times[label] = smoke.time_ms(torch, lambda: flash_decode(q, ck, cv, length),
                                         flush.zero_)
        decode_attention.decode_splits = rule
        print(f"  {name} phase-7 shape B={B} Smax={Smax} H={H} K={K} hd={hd}: "
              + ", ".join(f"{label} {1e3 * ms:.2f} us" for label, ms in times.items())
              + f"; decode_splits gives "
              f"{rule(B, K, Smax, torch.cuda.get_device_properties(dev).multi_processor_count)}")

    n_steps = (len(setups) + 1) * (ROUNDS + 1) * smoke.PROFILE_STEPS
    for label, step in served_steps(torch, np, dev, n_steps):
        compare(torch, label, step, setups)
    decode_attention.decode_splits = rule


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("faults", "evict-first", "splits"))
    args = ap.parse_args()
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("decode_variants: needs a CUDA device", file=sys.stderr)
        return 1
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi or "nvidia-smi: no output")
    if args.mode == "faults":
        faults(torch, dev)
    elif args.mode == "evict-first":
        evict_first(torch, np, dev)
    else:
        splits(torch, np, dev)
    return 0


if __name__ == "__main__":
    sys.exit(main())
