#!/usr/bin/env python3
"""The control of a cell's correctness check, at the cell's own size.

    python3 benchmark/control.py --workload <cell> --seeds <n> [<n> ...] [--fault half_batch]

The control is the plain reference computed with every weight product's
operands rounded to fp8 (e4m3, one scale a tensor: the next precision below
the configurations' bf16), put in the program's place: the cell's driver
compares its outputs with the fp32 reference's exactly as it compares the
program's. Each seed's numbers print beside the cell's limits; the control
has to fail at least one of them. The benchmark's own runs do not run it.
``--fault half_batch`` reads, in the same way, a training cell's reference
with half of every batch left out (the mean taken over the rest).
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[0] = ROOT  # the checkout's root, not this directory

from benchmark import harness  # noqa: E402


def readings(bench, cell_name: str, seed: int, fault: str = "") -> dict:
    cell = bench.cell(cell_name)
    config = bench.config(cell["config"])
    traffic = bench.traffic(cell["traffic"])
    run = harness.Run(cell_name, config, traffic, seed, False, "cuda",
                      bench.reference(config["reference"]))
    driver = bench.driver(traffic["driver"]).Driver(run)
    driver.make_inputs()
    return driver.fault(fault) if fault else driver.control()


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--fault", default="",
                   help="read a planted fault (a training cell's half_batch) instead")
    args = p.parse_args(argv)
    bench = harness.Bench(ROOT)
    limits = bench.limits(args.workload)
    failed_all = True
    for seed in args.seeds:
        t = time.perf_counter()
        got = readings(bench, args.workload, seed, args.fault)
        fails = sorted(k for k, v in got.items() if not v <= limits[k])
        failed_all &= bool(fails)
        print(json.dumps({"workload": args.workload, "seed": seed, "fault": args.fault,
                          "control": got,
                          "limits": limits, "fails": fails,
                          "seconds": time.perf_counter() - t}), flush=True)
    return 0 if failed_all else 1


if __name__ == "__main__":
    sys.exit(main())
