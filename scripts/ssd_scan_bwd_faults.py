#!/usr/bin/env python3
"""Plant faults in the reverse SSD state scan kernel and read them with the
checks of ``chip_smoke.py`` phase 2, on one GPU.

    python3 scripts/ssd_scan_bwd_faults.py

Each variant is a library compiled from a patched copy of
``src/repro_torch/kernels/csrc/ssd_scan_bwd.cu`` (which holds its own C
entry) under ``kernels/_build/variants/``; the checked-in source is never
changed.  For every case of phase 2 (``SCAN_BWD_CASES``) and three more
that reach the kernel's other paths (``EXTRA_CASES``), each with and
without an initial state and the final state's gradient, the script holds
the variant's (d_states, d_decays, d_init) against
``ref.ssd_state_scan_bwd_ref`` and autograd through the plain scan with
``chip_smoke.scan_bwd_close``, prints the largest error, and counts the
cases each fault touches and how many of them fail.
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

SOURCE = "ssd_scan_bwd.cu"

# (name, [(text in SOURCE, replacement), ...])
FAULTS = [
    ("the walk runs forwards",
     [("int chunk_of(int n, int C) { return C - 1 - n % C; }",
       "int chunk_of(int n, int C) { return n % C; }")]),
    ("a[c] dropped from the carry",
     [("float carry(float a, float G, float gp) { return fmaf(a, G, gp); }",
       "float carry(float a, float G, float gp) { return G + gp; }")]),
    ("g_final ignored",
     [("const bool has_gf = g_final != nullptr;", "const bool has_gf = false;")]),
    ("cluster rank 1's partial left out of d_decays",
     [("for (int q = 0; q < cs; ++q) s += cluster.map_shared_rank(blk + par * TILE, q)[j];",
       "for (int q = 0; q < cs; ++q)\n"
       "          s += q == 1 ? 0.f : cluster.map_shared_rank(blk + par * TILE, q)[j];")]),
    ("a prefetch stage hands the walk the next step's chunk",
     [("const long long src = at(chunk_of(n, C)) + e0;",
       "const long long src = at(chunk_of(n + 1, C)) + e0;")]),
]

# beyond phase 2: more chunks than one tile of chunk sums (32); P*N past
# eight blocks' 1280 elements, so each block walks its run in two passes;
# P*N % 4 != 0 over two blocks (the 4-byte path)
EXTRA_CASES = [(1, 70, 2, 16, 16), (1, 3, 2, 128, 96), (1, 4, 3, 45, 31)]

CAP = 1280          # elements of a (b, h) pair one block holds per pass, as the source


def cluster_size(PN: int) -> int:
    """The blocks the kernel splits a (b, h) pair over, as its launch picks them."""
    cs = 1
    while cs < 8 and -(-PN // cs) > CAP:
        cs *= 2
    return cs


# name -> whether a case (B, C, H, P, N, with an initial state, with
# g_final) reaches the fault: two chunks or more; a decay that scales
# something (two chunks, or g_final carried into d_init); a g_final; a
# second cluster rank and a d_decays that is not zero (a prefix that is not
# zero: two chunks, or an initial state); the TMA path (P*N % 4 == 0) and
# two chunks
TOUCHES = {
    FAULTS[0][0]: lambda B, C, H, P, N, init, gf: C >= 2,
    FAULTS[1][0]: lambda B, C, H, P, N, init, gf: C >= 2 or (init and gf),
    FAULTS[2][0]: lambda B, C, H, P, N, init, gf: gf,
    FAULTS[3][0]: lambda B, C, H, P, N, init, gf: cluster_size(P * N) >= 2 and (C >= 2 or init),
    FAULTS[4][0]: lambda B, C, H, P, N, init, gf: P * N % 4 == 0 and C >= 2,
}


def build_variants(variants):
    """{name: patches} -> {name: loaded library}; all compiled at once."""
    from repro_torch.kernels import _build
    source = (_build._CSRC / SOURCE).read_text()
    top = _build.BUILD_DIR / "variants"
    shutil.rmtree(top, ignore_errors=True)
    procs = {}
    for i, (name, patches) in enumerate(variants.items()):
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: {old!r} not once in {SOURCE}")
            text = text.replace(old, new)
        d = top / f"scan{i}"
        d.mkdir(parents=True)
        (d / SOURCE).write_text(text)
        so = d / "libscanbwd.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-I", str(_build._CSRC), "-shared",
             str(d / SOURCE), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name!r}:\n{out}")
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.ssd_scan_bwd.argtypes = [ptr] * 7 + [i32] * 6 + [ptr]
        lib.ssd_scan_bwd.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("ssd_scan_bwd_faults: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import ref
    from repro_torch.kernels import ssd_scan as scan
    dev = torch.device("cuda", 0)
    libs = build_variants({"sound": [], **dict(FAULTS)})
    library = scan.library
    for name, lib in libs.items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        worst, failed, touched, missed = 0.0, 0, 0, []
        cases = 0
        for B, C, H, P, N in smoke.SCAN_BWD_CASES + EXTRA_CASES:
            xs = torch.randn((B, C, H, P, N), generator=gen, device=dev)
            a = torch.rand((B, C, H), generator=gen, device=dev) * 0.69 + 0.3
            gp = torch.randn((B, C, H, P, N), generator=gen, device=dev)
            for s0 in (None, torch.randn((B, H, P, N), generator=gen, device=dev)):
                prefix, _ = scan.ssd_state_scan_fwd(xs, a, s0)
                for gf in (None, torch.randn((B, H, P, N), generator=gen, device=dev)):
                    init = s0 is not None
                    scan.library = lambda: lib
                    try:
                        got = scan.ssd_state_scan_bwd(gp, gf, prefix, a, init)
                    finally:
                        scan.library = library
                    want = ref.ssd_state_scan_bwd_ref(gp, gf, prefix, a, init)
                    leaves = [t.clone().requires_grad_() for t in (xs, a, s0) if t is not None]
                    auto = smoke.autograd_scan(torch, leaves, gp, gf)
                    err, ok = smoke.scan_bwd_close(got, want, prefix)
                    err_a, ok_a = smoke.scan_bwd_close(got, auto, prefix)
                    worst = max(worst, err, err_a)
                    bad = not (ok and ok_a)
                    failed += bad
                    cases += 1
                    case = (B, C, H, P, N, init, gf is not None)
                    if name in TOUCHES and TOUCHES[name](*case):
                        touched += 1
                        if not bad:
                            missed.append(case)
                    print(f"  [{name}] B={B} C={C} H={H} P={P} N={N} init={init} "
                          f"g_final={gf is not None}: max_abs_err vs closed form {err:.3e}, "
                          f"vs autograd {err_a:.3e}{' FAILS' if bad else ''}")
        print(f"[{name}]: largest max_abs_err {worst:.3e}; {failed} of {cases} cases fail "
              f"phase 2's check")
        if name in TOUCHES:
            print(f"[{name}] fails {touched - len(missed)} of the {touched} cases it touches; "
                  f"passes {missed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
