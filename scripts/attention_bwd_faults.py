#!/usr/bin/env python3
"""Plant faults in the attention backward kernel and read them with the
checks of ``chip_smoke.py`` phase 2, on one GPU.

    python3 scripts/attention_bwd_faults.py

Each variant is compiled from a patched copy of
``src/repro_torch/kernels/csrc/flash_attention_bwd.cu`` under
``kernels/_build/variants/``; the checked-in source is never changed.  For
every case of phase 2's ``BWD_CASES`` (the strided ones as contiguous
tensors; the sound kernel in f32 and bf16, each fault in bf16) the
script prints the two readings phase 2 checks on
dq, dk and dv against ``ref.attention_bwd_ref``: the largest elementwise
error (limit atol = rtol = ``chip_smoke.TOL``) and the largest error of one
row relative to its size (``chip_smoke.grad_row_rel_err``, limit
``GRAD_ROW_TOL``), then how many cases each limit catches.  A limit is
useful where it lies above the sound kernel's readings and below the
faults'.
"""

from __future__ import annotations

import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (stdlib only at import)

SOURCE = "flash_attention_bwd.cu"

# (name, [(text in flash_attention_bwd.cu, replacement), ...])
FAULTS = [
    ("dK/dV pass leaves out the last query tile",
     [("for (int qt = first; qt < n_qtiles; ++qt) {",
       "for (int qt = first; qt < n_qtiles - (n_qtiles > first + 1); ++qt) {")]),
    ("dK/dV pass leaves out the group's last query head",
     [("for (int g = 0; g < group; ++g) {",
       "for (int g = 0; g < (group > 1 ? group - 1 : 1); ++g) {")]),
    ("causal mask one key late",
     [("!(causal && kpos > qpos);", "!(causal && kpos > qpos + 1);")]),
    ("D left out of dS",
     [("dSs[i * kLdT + j] = p * (dp[r][c] - D_s[i]);", "dSs[i * kLdT + j] = p * dp[r][c];")]),
    ("dQ pass skips the second key tile",
     [("for (int k0 = 0; k0 < n_keys; k0 += BT) {",
       "for (int k0 = 0; k0 < n_keys; k0 += (k0 == 0 && n_keys > 2 * BT ? 2 * BT : BT)) {")]),
]


def build_variants(variants):
    """{name: patches} -> {name: loaded library}; all compiled at once."""
    from repro_torch.kernels import _build
    csrc = _build._CSRC
    source = (csrc / SOURCE).read_text()
    top = _build.BUILD_DIR / "variants"
    shutil.rmtree(top, ignore_errors=True)
    procs = {}
    for i, (name, patches) in enumerate(variants.items()):
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: {old!r} not once in {SOURCE}")
            text = text.replace(old, new)
        d = top / f"v{i}"
        d.mkdir(parents=True)
        (d / SOURCE).write_text(text)
        so = d / "libbwd.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-I", str(csrc), "-shared", str(d / SOURCE),
             "-o", str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name!r}:\n{out}")
        lib = ctypes.CDLL(str(so))
        ptr, i32, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
        lib.flash_attention_bwd.argtypes = [ptr] * 10 + [i32] * 9 + [i64p, ctypes.c_float, ptr]
        lib.flash_attention_bwd.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_bwd_faults: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    dev = torch.device("cuda", 0)
    libs = build_variants({"sound": [], **dict(FAULTS)})
    library = fa.library
    for name, lib in libs.items():
        for dtype_name in ("float32", "bfloat16") if name == "sound" else ("bfloat16",):
            dtype, tol = getattr(torch, dtype_name), smoke.TOL[dtype_name]
            row_tol = smoke.GRAD_ROW_TOL[dtype_name]
            gen = torch.Generator(device=dev)
            gen.manual_seed(0)
            worst_abs = worst_rel = 0.0
            caught_abs = caught_rel = 0
            for B, Sq, Sk, H, K, hd, causal, *strided in smoke.BWD_CASES:
                q, k, v, do = (torch.randn(s, generator=gen, device=dev).to(dtype)
                               for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd),
                                         (B, Sq, H, hd)))
                o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
                fa.library = lambda: lib
                try:
                    got = fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal)
                finally:
                    fa.library = library
                want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
                errs = [smoke.max_err(g, w, tol) for g, w in zip(got, want)]
                rels = [smoke.grad_row_rel_err(g, w, tol) for g, w in zip(got, want)]
                err = max(e for e, _ in errs)
                rel = max((r for r in rels if r is not None), default=0.0)
                worst_abs, worst_rel = max(worst_abs, err), max(worst_rel, rel)
                caught_abs += not all(ok for _, ok in errs)
                caught_rel += rel > row_tol
                print(f"  [{name}] {dtype_name} B={B} Sq={Sq} Sk={Sk} H={H} K={K} hd={hd} "
                      f"causal={causal}: max_abs_err={err:.3e} row_rel_err={rel:.3e}")
            print(f"[{name}] {dtype_name}: largest max_abs_err {worst_abs:.3e}, largest "
                  f"row_rel_err {worst_rel:.3e}; cases failing atol=rtol={tol}: {caught_abs}, "
                  f"failing row_rel_err <= {row_tol}: {caught_rel} of {len(smoke.BWD_CASES)}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
