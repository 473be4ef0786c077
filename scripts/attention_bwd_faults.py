#!/usr/bin/env python3
"""Plant faults in the bf16 attention backward kernels and read them with
the checks of ``chip_smoke.py`` phase 2, on one GPU.

    python3 scripts/attention_bwd_faults.py

Each variant is a library compiled from a patched copy of
``src/repro_torch/kernels/csrc/flash_attention_bwd_sm90.cu`` (the wgmma
dK/dV and dQ kernels) and the unchanged ``flash_attention_bwd.cu`` (the C
entry, D and the f32 path) under ``kernels/_build/variants/``; the
checked-in sources are never changed.  For every case of phase 2's
``BWD_CASES`` (the strided ones as contiguous tensors; the sound kernel in
f32 and bf16, each fault in bf16) the script prints the two readings phase 2
checks on dq, dk and dv against ``ref.attention_bwd_ref``: the largest
elementwise error (limit atol = rtol = ``chip_smoke.TOL``) and the largest
error of one row relative to its size (``chip_smoke.grad_row_rel_err``,
limit ``GRAD_ROW_TOL``), then how many cases each limit catches.  A limit is
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

SOURCE = "flash_attention_bwd_sm90.cu"
ENTRY = "flash_attention_bwd.cu"   # compiled unchanged beside each variant

# (name, [(text in SOURCE, replacement), ...]); no patch changes how many
# tiles a ring loads and waits for, so a variant cannot hang
FAULTS = [
    ("dK/dV pass leaves out the last query tile",
     [("const int nq = n_qtiles - first;",
       "const int nq = n_qtiles - first - (n_qtiles > first + 1);")]),
    ("dK/dV pass leaves out the group's last query head",
     [("const int n_pairs = group * nq;",
       "const int n_pairs = (group > 1 ? group - 1 : 1) * nq;")]),
    ("causal mask one key late",
     [("!(causal && kj > qi + off);", "!(causal && kj > qi + off + 1);")]),
    ("D left out of dS",
     [("return p * (dp - d);", "return p * dp;")]),
    ("dQ pass skips the second key tile",
     [("issue_acc<HD>(acc, dsa, k_stage(s));",
       "if (t != 1 || n_tiles <= 2) issue_acc<HD>(acc, dsa, k_stage(s));")]),
]

# name -> whether a case (B, Sq, Sk, H, K, hd, causal) reaches the fault:
# a second query tile; a group of two or more; a query that sees a key
# before the last; any case; a query tile that sees three key tiles
TOUCHES = {
    FAULTS[0][0]: lambda B, Sq, Sk, H, K, hd, causal: Sq > 64,
    FAULTS[1][0]: lambda B, Sq, Sk, H, K, hd, causal: H > K,
    FAULTS[2][0]: lambda B, Sq, Sk, H, K, hd, causal: causal and Sq >= 2,
    FAULTS[3][0]: lambda B, Sq, Sk, H, K, hd, causal: True,
    FAULTS[4][0]: lambda B, Sq, Sk, H, K, hd, causal: Sk > 128,
}


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
            [_build._nvcc(), *_build._FLAGS, "-I", str(csrc), "-shared", str(csrc / ENTRY),
             str(d / SOURCE), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
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
            touched, missed = 0, []
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
                failed = not all(ok for _, ok in errs) or rel > row_tol
                caught_abs += not all(ok for _, ok in errs)
                caught_rel += rel > row_tol
                case = (B, Sq, Sk, H, K, hd, causal)
                if name in TOUCHES and TOUCHES[name](*case):
                    touched += 1
                    if not failed:
                        missed.append(case)
                print(f"  [{name}] {dtype_name} B={B} Sq={Sq} Sk={Sk} H={H} K={K} hd={hd} "
                      f"causal={causal}: max_abs_err={err:.3e} row_rel_err={rel:.3e}")
            print(f"[{name}] {dtype_name}: largest max_abs_err {worst_abs:.3e}, largest "
                  f"row_rel_err {worst_rel:.3e}; cases failing atol=rtol={tol}: {caught_abs}, "
                  f"failing row_rel_err <= {row_tol}: {caught_rel} of {len(smoke.BWD_CASES)}")
            if name in TOUCHES:
                print(f"[{name}] fails {touched - len(missed)} of the {touched} cases it "
                      f"touches; passes {missed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
