#!/usr/bin/env python3
"""Plant faults in the f32 attention kernels (the forward A and the
backward A') and read them with the checks of ``chip_smoke.py`` phase 2, on
one GPU.

    python3 scripts/attention_f32_faults.py

Each variant is a library compiled from a patched copy of one f32 source
under ``kernels/_build/variants/``: ``flash_attention.cu`` alone (the
forward's C entry), or ``flash_attention_bwd.cu`` beside the unchanged
``flash_attention_bwd_sm90.cu`` (the backward's); the checked-in sources
are never changed.  A forward fault runs phase 2's f32 forward cases
(``ATTN_CASES`` and ``F32_EDGE_CASES``; the strided ones as contiguous
tensors), its output and log-sum-exp held to the plain version at
``chip_smoke.TOL``.  A backward fault runs the f32 backward cases
(``BWD_CASES`` and ``F32_EDGE_CASES``) from the sound forward's output and
log-sum-exp, dq, dk and dv held as phase 2 holds them: elementwise
(``TOL``) and row by row (``chip_smoke.grad_row_rel_err`` within
``GRAD_ROW_TOL``).  The sound library (the repository's own) runs both.
For each fault the script prints how many of the cases it touches fail:
a planted fault must fail every one.
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

FORWARD = "flash_attention.cu"
BACKWARD = "flash_attention_bwd.cu"
# compiled unchanged beside each backward variant
BACKWARD_ENTRY = "flash_attention_bwd_sm90.cu"

# (name, source, [(text in source, replacement), ...]); no patch changes how
# many copies a thread issues or waits for, so a variant cannot hang
FAULTS = [
    ("no O rescale when a row max moves", FORWARD,
     [("      for (int i = 0; i < NO; ++i) acc[r][i] *= c;\n", "")]),
    ("h % K in place of h / group", FORWARD,
     [("const int kh = h0 / group;", "const int kh = h0 % (H / group);")]),
    ("the causal diagonal one key late", FORWARD,
     [("if (causal && kpos > qpos) x = kNegInf;",
       "if (causal && kpos > qpos + 1) x = kNegInf;")]),
    ("the last ragged key tile unmasked", FORWARD,
     [("if (kpos >= Sk) x = -INFINITY;", "if (kpos >= Sk + BK) x = -INFINITY;")]),
    ("dS without - D", BACKWARD,
     [("ds = p * (dp - d);", "ds = p * dp;")]),
    ("dK and dV summed over the group's first head only", BACKWARD,
     [("const int n_steps = group * nq;", "const int n_steps = nq;")]),
    ("the dQ pass reads every key tile from the first K stage", BACKWARD,
     [("const float* Kt = Ks + (t & 1) * BT * LD;", "const float* Kt = Ks;")]),
]


def max_moves(B, Sq, Sk, H, K, hd, causal):
    """The expected number of (query, head) rows whose running max moves
    past the forward's first key tile (128 keys at hd 64, else 64), on
    random scores: a row that sees n keys, m of them past that tile, has
    its max among those with probability m / n."""
    tile = 128 if hd == 64 else 64
    off = Sk - Sq
    seen = (min(Sk, i + off + 1) if causal else Sk for i in range(Sq))
    return B * H * sum(max(0, n - tile) / n for n in seen)


# name -> whether a case (B, Sq, Sk, H, K, hd, causal) reaches the fault:
# rows whose max moves past the first key tile (8 expected: all miss it
# with probability e^-8); a head whose h % K and h / group differ; a query
# with a key after its own; a non-causal key tile past Sk (the causal mask
# hides those keys anyway); any case; a group of two or more; a query tile
# that sees two key tiles
TOUCHES = {
    FAULTS[0][0]: lambda *case: max_moves(*case) >= 8,
    FAULTS[1][0]: lambda B, Sq, Sk, H, K, hd, causal: H > K and K > 1,
    FAULTS[2][0]: lambda B, Sq, Sk, H, K, hd, causal: causal and Sq >= 2,
    FAULTS[3][0]: lambda B, Sq, Sk, H, K, hd, causal: not causal and Sk % 64 != 0,
    FAULTS[4][0]: lambda B, Sq, Sk, H, K, hd, causal: True,
    FAULTS[5][0]: lambda B, Sq, Sk, H, K, hd, causal: H > K,
    FAULTS[6][0]: lambda B, Sq, Sk, H, K, hd, causal: Sk > 64,
}


def build_variants():
    """{fault name: loaded library}; all compiled at once."""
    from repro_torch.kernels import _build
    csrc = _build._CSRC
    top = _build.BUILD_DIR / "variants"
    shutil.rmtree(top, ignore_errors=True)
    procs = {}
    for i, (name, source, patches) in enumerate(FAULTS):
        text = (csrc / source).read_text()
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: {old!r} not once in {source}")
            text = text.replace(old, new)
        d = top / f"f32_{i}"
        d.mkdir(parents=True)
        (d / source).write_text(text)
        so = d / "libf32.so"
        sources = [str(d / source)]
        if source == BACKWARD:
            sources.append(str(csrc / BACKWARD_ENTRY))
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-I", str(csrc), "-shared", *sources, "-o",
             str(so)], stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name!r}:\n{out}")
        lib = ctypes.CDLL(str(so))
        ptr, i32, i64p = ctypes.c_void_p, ctypes.c_int, ctypes.POINTER(ctypes.c_longlong)
        if hasattr(lib, "flash_attention_fwd"):
            lib.flash_attention_fwd.argtypes = [ptr] * 5 + [i32] * 9 + [i64p, ctypes.c_float,
                                                                       ptr]
            lib.flash_attention_fwd.restype = i32
        if hasattr(lib, "flash_attention_bwd"):
            lib.flash_attention_bwd.argtypes = [ptr] * 10 + [i32] * 9 + [i64p, ctypes.c_float,
                                                                        ptr]
            lib.flash_attention_bwd.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("attention_f32_faults: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import _build, ref
    from repro_torch.kernels import flash_attention as fa
    dev = torch.device("cuda", 0)
    print(smoke.card_line())
    sound = _build.library()
    libs = build_variants()
    tol, row_tol = smoke.TOL["float32"], smoke.GRAD_ROW_TOL["float32"]
    fwd_cases = [c[:7] for c in smoke.ATTN_CASES + smoke.F32_EDGE_CASES]
    bwd_cases = [c[:7] for c in smoke.BWD_CASES + smoke.F32_EDGE_CASES]

    def under(lib, fn):
        fa.library = lambda: lib
        try:
            return fn()
        finally:
            fa.library = _build.library

    def forward_fails(lib, case):
        B, Sq, Sk, H, K, hd, causal = case
        q, k, v = (torch.randn(s, generator=gen, device=dev)
                   for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd)))
        o, lse = under(lib, lambda: fa.flash_attention_fwd(q, k, v, causal=causal,
                                                           with_lse=True))
        err_o, ok_o = smoke.max_err(o, ref.attention_ref(q, k, v, causal=causal), tol)
        err_l, ok_l = smoke.max_err(lse, ref.attention_lse_ref(q, k, causal=causal), tol)
        return max(err_o, err_l), not (ok_o and ok_l), None

    def backward_fails(lib, case):
        B, Sq, Sk, H, K, hd, causal = case
        q, k, v, do = (torch.randn(s, generator=gen, device=dev)
                       for s in ((B, Sq, H, hd), (B, Sk, K, hd), (B, Sk, K, hd), (B, Sq, H, hd)))
        o, lse = fa.flash_attention_fwd(q, k, v, causal=causal, with_lse=True)
        got = under(lib, lambda: fa.flash_attention_bwd(q, k, v, o, lse, do, causal=causal))
        want = ref.attention_bwd_ref(q, k, v, o, lse, do, causal=causal)
        errs = [smoke.max_err(g, w, tol) for g, w in zip(got, want)]
        rels = [smoke.grad_row_rel_err(g, w, tol) for g, w in zip(got, want)]
        rel = max((r for r in rels if r is not None), default=0.0)
        return (max(e for e, _ in errs), not all(ok for _, ok in errs) or rel > row_tol, rel)

    runs = [("sound", sound, "forward"), ("sound", sound, "backward")] + [
        (name, libs[name], "forward" if source == FORWARD else "backward")
        for name, source, _ in FAULTS]
    caught_all = True
    for name, lib, direction in runs:
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        cases = fwd_cases if direction == "forward" else bwd_cases
        fails = forward_fails if direction == "forward" else backward_fails
        worst, failed, touched, missed = 0.0, 0, 0, []
        for case in cases:
            err, bad, rel = fails(lib, case)
            torch.cuda.synchronize()
            worst, failed = max(worst, err), failed + bad
            if name in TOUCHES and TOUCHES[name](*case):
                touched += 1
                if not bad:
                    missed.append(case)
            print(f"  [{name}] {direction} {case}: max_abs_err={err:.3e}"
                  f"{'' if rel is None else f' row_rel_err={rel:.3e}'}{' FAILS' if bad else ''}")
        print(f"[{name}] {direction}: largest max_abs_err {worst:.3e}; {failed} of {len(cases)} "
              f"cases fail phase 2's checks")
        if name in TOUCHES:
            print(f"[{name}] fails {touched - len(missed)} of the {touched} cases it touches; "
                  f"passes {missed}")
            caught_all = caught_all and not missed
        elif failed:
            caught_all = False
    print(f"every planted fault fails every case it touches, the sound kernels none: "
          f"{caught_all}")
    return 0 if caught_all else 1


if __name__ == "__main__":
    sys.exit(main())
