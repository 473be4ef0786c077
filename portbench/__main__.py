"""Run one cell of the port's benchmark on this machine's CUDA device.

    python3 -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  The port is imported from the checkout's
``src/``.  The last line of standard output is the result, as one JSON
object; the numbers compared for ``correct`` are the last lines of
standard error.  Without a CUDA device with the chips the cell asks for,
without the port's sources, or if JAX or the JAX package was loaded, the
run exits with a code other than 0 and prints no result.
"""

import time

T0 = time.perf_counter()     # set-up is timed from here, before torch is imported

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 -m portbench", description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from portbench import harness
    src = harness.ROOT / "src"
    if not (src / "repro_torch").is_dir():
        print(f"portbench: the port's sources are not at {src}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(src))
    bench = harness.load_benchmark()
    cell = harness.cell_of(bench, args.workload)

    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
        print(f"portbench: {args.workload} needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
              file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    record = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace), device, T0)
    info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": int(cell["chips"])}
    out, notes = harness.result_line(bench, cell, record, bool(args.trace), info,
                                     harness.limits_of(cell))
    bad = harness.forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {bad}; no result", file=sys.stderr)
        return 3
    for line in notes:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
