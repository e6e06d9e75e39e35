"""Run one cell on the CPU at its configuration's ``test_args``, through
the program's plain versions, and print the result line as
``perfbench/run.py`` does (which refuses to run without a card):

    python -m perfbench.tests.cpu_cell [--root DIR] --workload <name> --seed <n> --seconds <s> --trace <0|1>
"""

import sys

from perfbench import run


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    root = None
    if "--root" in argv:
        i = argv.index("--root")
        root = argv[i + 1]
        del argv[i: i + 2]
    kwargs = {"device_type": "cpu", "test": True}
    if root is not None:
        kwargs["root"] = root
    return run.main(argv, **kwargs)


if __name__ == "__main__":
    sys.exit(main())
