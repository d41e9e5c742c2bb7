"""Run one cell of BENCHMARK.json once: set up, measure, check, print.

    python3 bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout (also ``python3 -m bench.run`` there). It
needs a CUDA device; the last line of its standard output is the result.
"""
import time

T0 = time.monotonic()       # set-up is timed from here

import os  # noqa: E402
import sys  # noqa: E402


def _root() -> str:
    """The checkout's root, first on the path, with ``src`` after it; the
    bench directory itself off the path (its modules are ``bench.*``)."""
    here = os.path.dirname(os.path.abspath(__file__))
    root = os.path.dirname(here)
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != here]
    for p in (os.path.join(root, "src"), root):
        if p not in sys.path:
            sys.path.insert(0, p)
    return root


if __name__ == "__main__":
    ROOT = _root()
    from bench import harness
    sys.exit(harness.main(sys.argv[1:], ROOT, T0))
