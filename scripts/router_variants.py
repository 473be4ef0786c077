#!/usr/bin/env python3
"""Hold the fused MoE router kernel (``moe_router`` in
``src/repro_torch/kernels/csrc/moe_gating.cu``) against planted faults and
time its launch plans, on one GPU.  The checked-in source is never
changed: each variant is compiled from a patched copy under
``kernels/_build/variants/``.

    python3 scripts/router_variants.py faults
    python3 scripts/router_variants.py plans
    python3 scripts/router_variants.py parts

``faults`` plants faults in the kernels (one cluster rank's partial logits
left out of the reduction; one block reading its neighbour's D-slice, so
that a slice is summed twice and another never, in each kernel; four
router rows of every chunk skipped by the tile kernel; one warp's partial
left out by the decode kernel) and runs the ``moe_router`` cases of
``chip_smoke.py`` phase 2 on the sound kernels and on each variant,
printing the readings phase 2 checks against their limits: weights and
probabilities at atol = rtol = 2e-5, and the plain probability gap at a
rank against ``chip_smoke.ROUTER_TIE_DELTA``.

``plans`` times the kernel at phase 7's two router shapes (qwen3-moe
decode, T=4, and prefill, T=1200) under phase 7's two L2 flushes with
several (token rows per cluster, blocks per cluster) plans, the one
``router_plan`` picks marked, beside the chain it replaced.

``parts`` times, at the same two shapes and a few plans, variants that
leave parts of the kernels out (the tile kernel's loads and products, its
products; both kernels' x slab and their softmax / top-k; the decode
kernel's router loads), so that the differences show what each part
costs.
"""

from __future__ import annotations

import argparse
import ctypes
import shutil
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "src"))

import chip_smoke as smoke  # noqa: E402  (stdlib only at import)

# (name, [(text in moe_gating.cu, replacement), ...])
FAULTS = [
    ("one cluster rank's partial left out of the reduction (both kernels)",
     [("v[q][j] = q0 + q < cs ? src[32 * j] : 0.f;",
       "v[q][j] = q0 + q < cs - 1 ? src[32 * j] : 0.f;")]),
    ("tile: block 1 reads block 0's D-slice (one slice twice, one never)",
     [("const int c0 = rank * chunks_per_block;",
       "const int c0 = (rank == 1 ? 0 : rank) * chunks_per_block;")]),
    ("tile: the last four router rows of every chunk skipped",
     [("for (int kk = 0; kk < kv; kk += 4) {", "for (int kk = 0; kk < kv - 4; kk += 4) {")]),
    ("decode: block 1 reads block 0's router rows",
     [("const int d0 = rank * Dc;", "const int d0 = (rank == 1 ? 0 : rank) * Dc;")]),
    ("decode: the last warp's partial left out",
     [("for (int w = 1; w < ROWS; ++w)", "for (int w = 1; w < ROWS - 1; ++w)")]),
]


def build_variants(variants):
    """{name: patches} -> {name: loaded library}; all compiled at once."""
    from repro_torch.kernels import _build
    csrc = _build._CSRC
    source = (csrc / "moe_gating.cu").read_text()
    top = _build.BUILD_DIR / "variants"
    shutil.rmtree(top, ignore_errors=True)
    procs = {}
    for i, (name, patches) in enumerate(variants.items()):
        text = source
        for old, new in patches:
            if text.count(old) != 1:
                raise SystemExit(f"variant {name!r}: {old!r} not once in moe_gating.cu")
            text = text.replace(old, new)
        d = top / f"r{i}"
        d.mkdir(parents=True)
        (d / "moe_gating.cu").write_text(text)
        so = d / "librouter.so"
        procs[name] = (so, subprocess.Popen(
            [_build._nvcc(), *_build._FLAGS, "-I", str(csrc), "-shared",
             str(d / "moe_gating.cu"), "-o", str(so)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    libs = {}
    for name, (so, proc) in procs.items():
        out, _ = proc.communicate()
        if proc.returncode != 0:
            raise SystemExit(f"nvcc failed on variant {name!r}:\n{out}")
        lib = ctypes.CDLL(str(so))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.moe_router_fwd.argtypes = [ptr, i32] + [ptr] * 4 + [i32] * 7 + [ptr]
        lib.moe_router_fwd.restype = i32
        libs[name] = lib
    return libs


# (name, patches): the kernel with a part of its work left out
PARTS = [
    ("no loads or products",
     [("const int nc = max(0, min(chunks_per_block, (D + KC - 1) / KC - c0));",
       "const int nc = 0;")]),
    ("loads, no products",
     [("for (int kk = 0; kk < kv; kk += 4) {", "for (int kk = 0; kk < 0; kk += 4) {")]),
    ("no x slab, no x slice",
     [("load_x(xsl, xld, x + static_cast<long long>(row0) * D, D, c0 * KC, BM, xld, rows);",
       "(void)0;"),
      ("load_x(xs, Dc, x, D, d0, DECODE_ROWS, Dc, T);", "(void)0;")]),
    ("no softmax / top-k",
     [("  route_row<NV>(p, lane, E, k, weights + static_cast<long long>(i) * k,",
       "  if (E < 0) route_row<NV>(p, lane, E, k, weights + static_cast<long long>(i) * k,")]),
    ("decode: no router loads",
     [("? __ldg(rcol + static_cast<long long>(d) * E + 32 * j) : 0.f;", "? 0.f : 0.f;")]),
]


def faults(torch, dev) -> None:
    from repro_torch.kernels import moe_gating as wrappers
    from repro_torch.kernels import ref
    libs = build_variants({"sound": [], **dict(FAULTS)})
    tol, delta = smoke.TOL["float32"], smoke.ROUTER_TIE_DELTA
    for name, lib in libs.items():
        wrappers.library = lambda lib=lib: lib
        caught, passing = [], []
        for i, (T, D, E, k, dtype, dup) in enumerate(smoke.ROUTER_CASES):
            gen = torch.Generator(device=dev)
            gen.manual_seed(200 + i)
            x, router = smoke.router_inputs(torch, gen, dev, T, D, E, dtype, dup)
            r = smoke.check_router_output(torch, wrappers.moe_router(x, router, k),
                                          ref.moe_router_ref(x, router, k), E, exact_ids=dup)
            torch.cuda.synchronize()
            # how far past its limit the largest reading lies (< 1: within)
            margin = max(r["err_w"] / tol, r["err_p"] / tol, r["gap"] / delta)
            (passing if r["ok"] else caught).append(margin)
            print(f"  [{name}] T={T} D={D} E={E} k={k} {dtype}{' repeated' if dup else ''}: "
                  f"weights err {r['err_w']:.3e}, probs err {r['err_p']:.3e}, prob gap "
                  f"{r['gap']:.3e}, rows with other ids {r['rows_differ']}, "
                  f"|d log p| {r['dlogp']:.3e}: {'caught' if not r['ok'] else 'passes'} "
                  f"(largest reading / its limit {margin:.3g})")
        print(f"[{name}]: {len(caught)} of {len(smoke.ROUTER_CASES)} cases fail phase 2's "
              f"checks" + (f", their largest reading at least {min(caught):.3g}x its limit"
                           if caught else "")
              + (f"; the passing cases' largest reading at most {max(passing):.3g}x its limit"
                 if passing else ""))


def plans(torch, dev, libs=None, shapes=None) -> None:
    from repro_torch.configs.base import get_config
    from repro_torch.kernels import ref
    from repro_torch.kernels._build import library
    from repro_torch.kernels.moe_gating import router_plan
    libs = libs or {"as is": library()}
    shapes = shapes or {   # (rows, cluster): rows 0 is the decode kernel
        4: [(0, 4), (0, 8), (0, 16), (16, 8), (16, 16)],
        1200: [(r, c) for r in (16, 80) for c in (4, 8, 16)]}
    m = get_config(smoke.MOE_RUN[0])
    D, E, k = m.d_model, m.n_experts, m.top_k
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    buf = torch.empty(64 << 20, dtype=torch.float32, device=dev)
    flushes = {"write": buf.zero_, "read": buf.sum}
    gen = torch.Generator(device=dev)
    gen.manual_seed(1)
    for T, candidates in shapes.items():
        x, router = smoke.router_inputs(torch, gen, dev, T, D, E, "bfloat16", False)
        w = torch.empty((T, k), device=dev)
        ids = torch.empty((T, k), dtype=torch.int32, device=dev)
        probs = torch.empty((T, E), device=dev)
        stream = torch.cuda.current_stream(dev).cuda_stream

        def launch(plan, lib):
            err = lib.moe_router_fwd(x.data_ptr(), 1, router.data_ptr(), w.data_ptr(),
                                     ids.data_ptr(), probs.data_ptr(), dev.index, T, D, E, k,
                                     *plan, stream)
            if err:
                raise RuntimeError(f"moe_router plan {plan}: CUDA error {err}")

        chosen = router_plan(T, D, sms)
        want = ref.moe_router_ref(x, router, k)
        for name, lib in libs.items():
            for plan in candidates:
                label = (f"decode kernel, a cluster of {plan[1]}" if plan[0] == 0
                         else f"tile kernel, rows {plan[0]} cluster {plan[1]}")
                try:
                    launch(plan, lib)
                    torch.cuda.synchronize()
                except RuntimeError as exc:   # e.g. a cluster the card cannot place
                    print(f"  [{name}] T={T} {label}: {exc}")
                    continue
                r = smoke.check_router_output(torch, (w, ids, probs), want, E, exact_ids=False)
                times = {f: smoke.time_ms(torch, lambda: launch(plan, lib), fl)
                         for f, fl in flushes.items()}
                mark = " (router_plan)" if plan == chosen else ""
                print(f"  [{name}] T={T} {label}{mark}: "
                      + ", ".join(f"{1e3 * ms:.2f} us under a {f} flush"
                                  for f, ms in times.items())
                      + f"; agrees with the plain version: {r['ok']}")
        for f, fl in flushes.items():
            ms = smoke.time_ms(torch, lambda: smoke.router_chain(x, router, k), fl)
            print(f"  T={T} the chain it replaced: {1e3 * ms:.2f} us under a {f} flush")


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("mode", choices=("faults", "plans", "parts"))
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("router_variants: needs a CUDA device", file=sys.stderr)
        return 1
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda", 0)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True, text=True,
                         timeout=60).stdout.strip()
    print(smi or "nvidia-smi: no output")
    if args.mode == "faults":
        faults(torch, dev)
    elif args.mode == "plans":
        plans(torch, dev)
    else:
        plans(torch, dev, build_variants({"as is": [], **dict(PARTS)}),
              {4: [(0, 16), (16, 16)], 1200: [(80, 8), (16, 8)]})
    return 0


if __name__ == "__main__":
    sys.exit(main())
