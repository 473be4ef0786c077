#!/usr/bin/env python3
"""Print the dry run's artifacts as a markdown table.

    python3 scripts/dryrun_table.py [ARTIFACT_DIR]

``ARTIFACT_DIR`` defaults to ``artifacts/dryrun_torch`` (what
``python -m repro_torch.launch.dryrun --all --mesh both`` writes).  One row
an (arch, shape) cell, each entry "single / multi" (the 16 x 16 and the
2 x 16 x 16 mesh).  Columns:
the dominant term; the compute, memory and collective terms in seconds a
rank (``roofline/analysis.py``'s H100 data-sheet rates); argument and
temporary GB a rank; the useful ratio; the trace's CPU seconds
(``compile_s``).  A failed cell prints its error.
"""

from __future__ import annotations

import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]


def _cell(r) -> list:
    if r is None:
        return ["-"] * 8
    if r["status"] != "ok":
        return [f"FAILED: {r['error'][:60]}"] + [""] * 7
    return [r["dominant"], f"{r['compute_s']:.4f}", f"{r['memory_s']:.4f}",
            f"{r['collective_s']:.4f}", f"{r['argument_bytes'] / 1e9:.2f}",
            f"{r['temp_bytes'] / 1e9:.2f}", f"{r['useful_ratio']:.3f}", f"{r['compile_s']}"]


def main() -> int:
    d = Path(sys.argv[1]) if len(sys.argv) > 1 else ROOT / "artifacts" / "dryrun_torch"
    cells: dict = {}
    for p in sorted(d.glob("*.json")):
        r = json.loads(p.read_text())
        mesh = "multi" if r["mesh"] in ("multi", "2x16x16") else "single"
        cells.setdefault((r["arch"], r["shape"]), {})[mesh] = r
    if not cells:
        print(f"no artifacts in {d}", file=sys.stderr)
        return 1
    print("| arch | shape | dominant | compute s | memory s | collective s | args GB | "
          "temp GB | useful | trace CPU s |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    ok = 0
    for (arch, shape), by_mesh in cells.items():
        one, two = _cell(by_mesh.get("single")), _cell(by_mesh.get("multi"))
        ok += sum(r["status"] == "ok" for r in by_mesh.values())
        print(f"| {arch} | {shape} | " + " | ".join(f"{a} / {b}" for a, b in zip(one, two))
              + " |")
    print(f"\n{ok} of {sum(len(v) for v in cells.values())} cells ok "
          f"(each entry: the 16x16 mesh / the 2x16x16 mesh)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
