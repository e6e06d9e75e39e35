"""Run one cell of the benchmark once and print the result line.

    python3 perfbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

Run from the root of a checkout (``python -m perfbench.run`` works too).
It loads, warms up, measures for ``--seconds``, checks the window's answers
against the plain reference, prints each compared number beside its limit
as the last lines of standard error, and prints one JSON object as the last
line of standard output.  Without the CUDA devices the cell asks for, or
with JAX or the JAX package loaded once the window has closed, it exits
with 2 and prints no result.
"""

import time

T0_WALL = time.time()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

if __name__ == "__main__" and not __package__:
    # run as a script: import the package from the checkout's root
    sys.path[0] = str(Path(__file__).resolve().parent.parent)


def main(argv=None, **run_kwargs) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    from perfbench import harness

    try:
        line = harness.run(args.workload, args.seed, args.seconds, bool(args.trace), t_setup0_wall=T0_WALL,
                           **run_kwargs)
    except harness.NoResult as e:
        print(f"perfbench: no result: {e}", file=sys.stderr, flush=True)
        return 2
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line, allow_nan=False), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
