"""Run one cell of the benchmark once on the card and print its result.

    python3 benchmarks/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell, its configuration, its traffic mix and its driver are found by
name from ``BENCHMARK.json`` (``benchmarks/harness/spec.py``).  The last line
on stdout is the result as one JSON object; the last lines on stderr are the
numbers compared with the reference, each beside its limit.  Without a CUDA
card, or with fewer cards than the cell asks for, it prints no result and
exits with a code other than 0.  Every process the run starts has ended,
and been waited for, when it exits (``benchmarks/harness/procs.py``).
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = p.parse_args(argv)
    from benchmarks.harness import procs, runner

    procs.adopt_orphans()
    try:
        return runner.run(a.workload, a.seed, a.seconds, bool(a.trace), T0)
    finally:
        procs.end_all()


if __name__ == "__main__":
    sys.exit(main())
