#!/usr/bin/env python3
"""Plant faults in the MoE router backward kernel and read them with the
checks of ``chip_smoke.py`` phase 2, on one GPU.

    python3 scripts/router_bwd_faults.py

Each variant is a library compiled from a patched copy of
``src/repro_torch/kernels/csrc/moe_router_bwd.cu`` (which holds its own C
entry) under ``kernels/_build/variants/``; the checked-in source is never
changed.  For every case of phase 2 (``ROUTER_BWD_ROWS`` token rows at
qwen3-moe's D = 2048, E = 128, k = 8, router columns distinct and
repeated, the probabilities' gradient present and absent), the script
holds the variant's dlogits against ``ref.moe_router_bwd_ref`` on the
forward kernel's own outputs with ``chip_smoke.grads_close``, prints the
largest error, and counts the cases each fault touches and how many of them
fail.
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

SOURCE = "moe_router_bwd.cu"

# (name, [(text in SOURCE, replacement), ...])
FAULTS = [
    ("s_j taken from the wrong lane",
     [("const int src = id % 32;", "const int src = (id + 1) % 32;")]),
    ("ds never scattered",
     [("if (lane + 32 * i == col) g[i] += d;",
       "if (lane + 32 * i == col) g[i] += 0.f * d;")]),
    ("gprobs ignored",
     [("const bool has_gp = gprobs != nullptr;", "const bool has_gp = false;")]),
]

# name -> whether a case (T, E, router columns repeated, gprobs present)
# reaches the fault: every row reads s_j and scatters ds; gprobs only when
# present
TOUCHES = {
    FAULTS[0][0]: lambda T, E, dup, gp: True,
    FAULTS[1][0]: lambda T, E, dup, gp: True,
    FAULTS[2][0]: lambda T, E, dup, gp: gp,
}

D, K = 2048, 8
CASES = [(T, 128, dup) for T in smoke.ROUTER_BWD_ROWS for dup in (False, True)]


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
        d = top / f"router{i}"
        d.mkdir(parents=True)
        (d / SOURCE).write_text(text)
        so = d / "librouterbwd.so"
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
        lib.moe_router_bwd.argtypes = [ptr] * 6 + [i32] * 4 + [ptr]
        lib.moe_router_bwd.restype = i32
        libs[name] = lib
    return libs


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("router_bwd_faults: needs a CUDA device", file=sys.stderr)
        return 1
    from repro_torch.kernels import moe_gating as gating
    from repro_torch.kernels import ref
    dev = torch.device("cuda", 0)
    libs = build_variants({"sound": [], **dict(FAULTS)})
    library = gating.library
    for name, lib in libs.items():
        gen = torch.Generator(device=dev)
        gen.manual_seed(0)
        worst, failed, touched, missed, cases = 0.0, 0, 0, [], 0
        for T, E, dup in CASES:
            x, router = smoke.router_inputs(torch, gen, dev, T, D, E, "bfloat16", dup)
            w, ids, probs = gating.moe_router_fwd(x, router, K)
            gw = torch.randn((T, K), generator=gen, device=dev)
            gprobs = torch.randn((T, E), generator=gen, device=dev)
            for gp in (gprobs, None):
                gating.library = lambda: lib
                try:
                    got = gating.moe_router_bwd(gw, gp, w, ids, probs)
                finally:
                    gating.library = library
                want = ref.moe_router_bwd_ref(gw, gp, w, ids, probs)
                torch.cuda.synchronize()
                (err,), _, ok = smoke.grads_close([got], [want], ["float32"])
                worst = max(worst, err)
                failed += not ok
                cases += 1
                case = (T, E, dup, gp is not None)
                if name in TOUCHES and TOUCHES[name](*case):
                    touched += 1
                    if ok:
                        missed.append(case)
                print(f"  [{name}] T={T} E={E} k={K}{' repeated columns' if dup else ''} "
                      f"gprobs {'present' if gp is not None else 'absent'}: max_abs_err "
                      f"{err:.3e}{'' if ok else ' FAILS'}")
        print(f"[{name}]: largest max_abs_err {worst:.3e}; {failed} of {cases} cases fail "
              f"phase 2's check")
        if name in TOUCHES:
            print(f"[{name}] fails {touched - len(missed)} of the {touched} cases it touches; "
                  f"passes {missed}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
