"""The control of a cell's check, on the card at the cell's own size:
for each seed, one run's window (``--seconds``, as long as a run's, so
that as many samples or steps are compared), then the check's numbers of
the program and of the control, the reference computed in bfloat16 in the
program's place. The control has to fail the cell's limits.

    python3 h100_bench/control.py --workload <name> --seconds <s> \\
        --seeds <n> [<n> ...]

Prints one JSON line per seed: {"seed", "program", "control", "limits"},
and what the mix's kind adds for the record (``kinds/<kind>.py``,
``control_readings``: a train cell's planted faults, a render cell's sums
of differences).
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))


def readings(workload, seed, seconds, device="cuda", **where):
    from h100_bench import harness

    m = harness.measure_all(workload, seed, seconds, False, device, **where)
    args = (m.outputs, m.cell.config, m.cell.traffic, m.arrays)
    return {"seed": seed, "program": m.kind.check(*args),
            **m.kind.control_readings(*args), "limits": m.cell.limits}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    args = ap.parse_args(argv)
    for seed in args.seeds:
        print(json.dumps(readings(args.workload, seed, args.seconds)),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
