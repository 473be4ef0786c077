#!/usr/bin/env python3
"""Time the two backward kernels against another version of their sources,
in turns on one GPU, at ``chip_smoke.py`` phase 7's shapes.

    python3 scripts/bwd_kernels_ab.py OTHER_CSRC_DIR
    python3 scripts/bwd_kernels_ab.py --scan-4-byte-path

``OTHER_CSRC_DIR`` holds another ``ssd_scan_bwd.cu`` and
``moe_router_bwd.cu`` (for example a parent commit's, from ``git show``);
they are compiled into one library under ``kernels/_build/variants/``
beside the repository's own.  ``--scan-4-byte-path`` takes as the other
version a copy of the repository's own sources whose reverse scan always
takes its 4-byte register path, to weigh the TMA ring against it.  For the reverse state scan at phase 11's
Mamba2 block (B=4, C=4, H=64, P=80, N=64, no initial state, the final
state unread) and the router backward at phase 10's (T=4096, E=128, k=8,
gprobs present), each version's result is held to its closed form, and
then the two are timed as phase 7 times a kernel (``chip_smoke.time_ms``,
median of 25 calls, L2 flushed by writing 256 MB, then by reading them) in
the order other, this, this, other.  Those times carry the event method's
own floor (a one-element PyTorch op's time is printed beside them), so each
version's kernel is also timed by ``torch.profiler``: its mean device
duration over 20 calls, each after a read flush.  The last line is a JSON
object of the times in ms.
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

SOURCES = ("ssd_scan_bwd.cu", "moe_router_bwd.cu")
# the reverse scan's choice of path in its C entry, and that choice forced
# to the 4-byte register path
TMA_CHOICE = "const bool tma = PN % 4 == 0 &&"
NO_TMA = "const bool tma = false && PN % 4 == 0 &&"


def four_byte_sources() -> Path:
    """A copy of the repository's two sources in which the reverse scan
    always takes its 4-byte register path."""
    from repro_torch.kernels import _build
    d = _build.BUILD_DIR / "variants" / "four_byte_src"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    for src in SOURCES:
        text = (_build._CSRC / src).read_text()
        if src == "ssd_scan_bwd.cu":
            if text.count(TMA_CHOICE) != 1:
                raise SystemExit(f"{TMA_CHOICE!r} not once in {src}")
            text = text.replace(TMA_CHOICE, NO_TMA)
        (d / src).write_text(text)
    return d


def build_other(csrc: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    d = _build.BUILD_DIR / "variants" / "other"
    shutil.rmtree(d, ignore_errors=True)
    d.mkdir(parents=True)
    so = d / "libother.so"
    out = subprocess.run([_build._nvcc(), *_build._FLAGS, "-I", str(_build._CSRC), "-shared",
                          *(str(csrc / src) for src in SOURCES), "-o", str(so)],
                         stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    if out.returncode != 0:
        raise SystemExit(f"nvcc failed on {csrc}:\n{out.stdout}")
    lib = ctypes.CDLL(str(so))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.ssd_scan_bwd.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
    lib.ssd_scan_bwd.restype = i32
    lib.moe_router_bwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
    lib.moe_router_bwd.restype = i32
    return lib


def profiled_ms(torch, fn, flush, symbol, n=20):
    """Mean device duration of the kernels whose name holds ``symbol``,
    over ``n`` calls of ``fn``, each after ``flush()``."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            flush()
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages() if symbol in e.key]
    return sum(e.device_time_total for e in hits) / max(1, sum(e.count for e in hits)) / 1e3


def router_close(out, want):
    """(largest elementwise err, within phase 2's tolerances)"""
    (err,), _, ok = smoke.grads_close([out], [want], ["float32"])
    return err, ok


def main() -> int:
    import torch
    if len(sys.argv) != 2:
        print(__doc__.split("\n\n")[1], file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("bwd_kernels_ab: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import moe_gating as gating
    from repro_torch.kernels import ssd_scan as scan
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi)
    other_dir = (four_byte_sources() if sys.argv[1] == "--scan-4-byte-path"
                 else Path(sys.argv[1]).resolve())
    this, other = _build.library(), build_other(other_dir)
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    buf = torch.empty(64 << 20, dtype=torch.float32, device=dev)   # 256 MB > L2
    flushes = {"write": buf.zero_, "read": buf.sum}

    a = torch.rand((4, 4, 64), generator=gen, device=dev) * 0.69 + 0.3
    prefix, _ = scan.ssd_state_scan_fwd(
        torch.randn((4, 4, 64, 80, 64), generator=gen, device=dev), a)
    gp = torch.randn((4, 4, 64, 80, 64), generator=gen, device=dev)
    x = torch.randn((4096, 2048), generator=gen, device=dev).to(torch.bfloat16)
    router = torch.randn((2048, 128), generator=gen, device=dev) * 2048 ** -0.5
    w, ids, probs = gating.moe_router_fwd(x, router, 8)
    gw = torch.randn((4096, 8), generator=gen, device=dev)
    gprobs = torch.randn((4096, 128), generator=gen, device=dev) / 4096

    def with_lib(module, lib, fn):
        def call():
            module.library = lambda: lib
            try:
                return fn()
            finally:
                module.library = _build.library
        return call

    kernels = {
        "ssd_state_scan_bwd": (scan, lambda: scan.ssd_state_scan_bwd(gp, None, prefix, a, False),
                               lambda: ref.ssd_state_scan_bwd_ref(gp, None, prefix, a, False),
                               lambda out, want: smoke.scan_bwd_close(out, want, prefix)),
        "moe_router_bwd": (gating, lambda: gating.moe_router_bwd(gw, gprobs, w, ids, probs),
                           lambda: ref.moe_router_bwd_ref(gw, gprobs, w, ids, probs),
                           router_close),
    }
    one = torch.zeros(1, device=dev)
    result = {"device": smi, **{f"one-element op {f} flush ms": smoke.time_ms(
        torch, lambda: one.add_(1), flush) for f, flush in flushes.items()}}
    print(f"  launch floor: {result}")
    for name, (module, fn, plain, close) in kernels.items():
        want = plain()
        for label, lib in (("other", other), ("this", this)):
            err, ok = close(with_lib(module, lib, fn)(), want)
            print(f"  {name} [{label}]: max_abs_err {err:.3e}{'' if ok else ' FAILS'}")
            if not ok:
                return 1
        for flush_name, flush in flushes.items():
            times = {"other": [], "this": []}
            for label in ("other", "this", "this", "other"):
                lib = other if label == "other" else this
                times[label].append(smoke.time_ms(torch, with_lib(module, lib, fn), flush))
            for label, ts in times.items():
                result[f"{name} {label} {flush_name} flush ms"] = ts
            print(f"  {name}, L2 flushed by {flush_name}: other {times['other']}, "
                  f"this {times['this']} ms")
        symbol = smoke.KERNEL_SYMBOLS[name][0]
        for label in ("other", "this"):
            lib = other if label == "other" else this
            result[f"{name} {label} profiled ms"] = profiled_ms(
                torch, with_lib(module, lib, fn), flushes["read"], symbol)
        print(f"  {name}, device duration (profiler, after a read flush): other "
              f"{result[f'{name} other profiled ms']:.5f}, this "
              f"{result[f'{name} this profiled ms']:.5f} ms")
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
