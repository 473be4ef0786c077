#!/usr/bin/env python3
"""Time the f32 attention kernels (forward A and backward A') against
another version of their sources, and PyTorch's SDPA in f32, in turns on one
GPU, at ``chip_smoke.py`` phase 7's two f32 shapes.

    python3 scripts/attention_f32_ab.py OTHER_CSRC_DIR

``OTHER_CSRC_DIR`` holds another ``flash_attention.cu``,
``flash_attention_bwd.cu`` and ``flash_attention_bwd_sm90.cu`` with the
headers they include (for example a parent commit's ``csrc/``, unpacked
with ``git archive``); they are compiled into one library under
``kernels/_build/variants/`` beside the repository's own.  The shapes are
seamless-m4t-large-v2's encoder layer (B=4, S=1024, H=K=16, hd 64, no
mask) and a lidc-100m training layer (B=4, S=1024, H=10, K=5, hd 64,
causal).  Each version's output is held to the plain version at phase 2's
tolerances, then the two are timed as phase 7 times a kernel
(``chip_smoke.time_ms``: median of 25 calls, L2 flushed by writing 256 MB)
in the order other, this, this, other, beside SDPA's forward and backward
in f32 (``torch.nn.functional.scaled_dot_product_attention``, TF32 off).
``torch.profiler`` then gives each one's device time per call and the names
of the CUDA kernels SDPA launches in f32.  The last line is a JSON object of
the readings.
"""

from __future__ import annotations

import ctypes
import json
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (stdlib only at import)

SOURCES = ("flash_attention.cu", "flash_attention_bwd.cu", "flash_attention_bwd_sm90.cu")
SHAPES = {  # name: (B, S, H, K, hd, causal)
    "seamless encoder layer": (4, 1024, 16, 16, 64, False),
    "lidc-100m training layer": (4, 1024, 10, 5, 64, True),
}


def build_other(csrc: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    d = _build.BUILD_DIR / "variants" / "attention_other"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    so = d / "libother.so"
    out = subprocess.run([_build._nvcc(), *_build._FLAGS, "-I", str(csrc), "-shared",
                          *(str(csrc / src) for src in SOURCES), "-o", str(so)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed on {csrc}:\n{out.stdout}")
    lib = ctypes.CDLL(str(so))
    ptr, i32, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
    lib.flash_attention_fwd.argtypes = [ptr] * 5 + [i32] * 9 + [i64p, ctypes.c_float, ptr]
    lib.flash_attention_fwd.restype = i32
    lib.flash_attention_bwd.argtypes = [ptr] * 10 + [i32] * 9 + [i64p, ctypes.c_float, ptr]
    lib.flash_attention_bwd.restype = i32
    return lib


def profile_kernels(torch, fn, flush, n=20):
    """{CUDA kernel name: device us per call of ``fn``} over ``n`` calls,
    each after ``flush()``; the flush's own kernels are left out."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as flushed:
        for _ in range(n):
            flush()
        torch.cuda.synchronize()
    skip = {e.key for e in flushed.key_averages() if e.device_time_total > 0}
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush()
            fn()
        torch.cuda.synchronize()
    return {e.key: e.device_time_total / n for e in prof.key_averages()
            if e.key not in skip and e.device_time_total > 0}


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("attention_f32_ab: needs a CUDA device", file=sys.stderr)
        return 1
    import torch.nn.functional as F
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0)
    card = smoke.card_line()
    print(card)
    this, other = _build.library(), build_other(Path(sys.argv[1]).resolve())
    libs = {"other": other, "this": this}
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    buf = torch.empty(64 << 20, dtype=torch.float32, device=dev)   # 256 MB > L2
    flush = buf.zero_
    tol, row_tol = smoke.TOL["float32"], smoke.GRAD_ROW_TOL["float32"]

    def with_lib(lib, fn):
        def call():
            fa.library = lambda: lib
            try:
                return fn()
            finally:
                fa.library = _build.library
        return call

    result = {"device": card}
    for shape, (B, S, H, K, hd, causal) in SHAPES.items():
        q, k, v, do = (torch.randn(s, generator=gen, device=dev)
                       for s in ((B, S, H, hd), (B, S, K, hd), (B, S, K, hd), (B, S, H, hd)))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
        leaves = [t.transpose(1, 2).detach().requires_grad_() for t in (q, k, v)]
        sdpa_out = F.scaled_dot_product_attention(*leaves, is_causal=causal, enable_gqa=True)
        calls = {
            "A": lambda: fa.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)[0],
            "A'": lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal),
        }
        library = {
            "A": lambda: F.scaled_dot_product_attention(
                *(t.transpose(1, 2) for t in (q, k, v)), is_causal=causal, enable_gqa=True),
            "A'": lambda: torch.autograd.grad(sdpa_out, leaves, do.transpose(1, 2),
                                              retain_graph=True),
        }
        want = {"A": ref.attention_ref(q, k, v, causal=causal),
                "A'": ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)}
        for name, fn in calls.items():
            for label, lib in libs.items():
                got = with_lib(lib, fn)()
                outs = got if name == "A'" else (got,)
                wants = want[name] if name == "A'" else (want[name],)
                errs = [smoke.max_err(g, w, tol) for g, w in zip(outs, wants)]
                rels = [smoke.grad_row_rel_err(g, w, tol) for g, w in zip(outs, wants)]
                ok = all(e[1] for e in errs) and all(r is None or r <= row_tol for r in rels)
                print(f"  {name} [{label}] {shape}: max_abs_err "
                      f"{max(e[0] for e in errs):.3e}{'' if ok else ' FAILS'}")
                if not ok:
                    return 1
            times = {"other": [], "this": []}
            for label in ("other", "this", "this", "other"):
                times[label].append(smoke.time_ms(torch, with_lib(libs[label], fn), flush))
            lib_ms = smoke.time_ms(torch, library[name], flush)
            prof = {label: profile_kernels(torch, with_lib(lib, fn), flush)
                    for label, lib in libs.items()}
            sdpa_prof = profile_kernels(torch, library[name], flush)
            for label, ts in times.items():
                result[f"{name} {shape} {label} ms"] = ts
                result[f"{name} {shape} {label} device us"] = sum(prof[label].values())
            result[f"{name} {shape} SDPA f32 ms"] = lib_ms
            result[f"{name} {shape} SDPA f32 kernels us"] = sdpa_prof
            print(f"  {name} {shape}: other {times['other']} ms, this {times['this']} ms, "
                  f"SDPA f32 {lib_ms:.4f} ms")
            for label in libs:
                print(f"    {label}: device us per call {sum(prof[label].values()):.2f} "
                      f"({', '.join(f'{k}: {u:.2f}' for k, u in prof[label].items())})")
            print(f"    SDPA f32 kernels, device us per call: "
                  f"{json.dumps({k: round(u, 2) for k, u in sdpa_prof.items()})}")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
