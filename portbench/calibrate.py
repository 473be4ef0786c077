"""Readings for setting the limits of ``correct``: the port's numbers and
the fp8 control's over many seeds, or a planted fault's, in one process
(the kernels are built or loaded once).  The benchmark's own runs never
run this.

    python3 -m portbench.calibrate --workload <cell> --seeds 11,12,13 \
        --seconds 30 [--control] [--fault half_batch] [--out FILE]

prints one JSON line a seed: the readings beside the control's, the cell's
end-to-end metrics at this window and the peak memory.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def main(argv=None) -> int:
    from portbench import faults, harness
    ap = argparse.ArgumentParser(prog="python3 -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated")
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--control", action="store_true")
    ap.add_argument("--fault", choices=faults.FAULTS)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(harness.ROOT / "src"))
    import torch
    if not torch.cuda.is_available():
        print("calibrate: no CUDA device", file=sys.stderr)
        return 2
    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)
    device = torch.device("cuda", 0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1}
    for seed in (int(s) for s in args.seeds.split(",")):
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        record = harness.run_cell(cell, seed, args.seconds, False, device, t0,
                                  control=args.control, fault=args.fault)
        out, _ = harness.result_line(bench, cell, record, False, info, harness.limits_of(cell))
        line = {"workload": args.workload, "seed": seed, "fault": args.fault,
                "readings": record["readings"], "control": record.get("control"),
                "checked_tokens": record.get("checked_tokens"),
                "metrics": {k: v["value"] for k, v in out["metrics"].items()},
                "memory_peak_bytes": record["memory_peak_bytes"],
                "run_s": time.perf_counter() - t0, "notes": record.get("bases", [])}
        text = json.dumps(line)
        print(text, flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(text + "\n")
        del record
    return 0


if __name__ == "__main__":
    sys.exit(main())
