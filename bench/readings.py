"""The readings that the limits of ``correct`` are set from, on the card:
for each seed, one set-up and a short window of the cell at its own
load, then the numbers compared for the program's answers and for the
control (the reference computed in bfloat16, put in the program's
place) on the same answers. Not run by the benchmark's runs.

    python3 bench/readings.py --workload <cell> --seeds 11,12,13 --seconds 5

One JSON line a seed on standard output.
"""
import time

T0 = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

if __name__ == "__main__":
    HERE = os.path.dirname(os.path.abspath(__file__))
    ROOT = os.path.dirname(HERE)
    sys.path[:] = [p for p in sys.path
                   if os.path.abspath(p or os.curdir) != HERE]
    sys.path[:0] = [os.path.join(ROOT, "src"), ROOT]
    import torch
    from bench import discovery

    p = argparse.ArgumentParser(prog="bench/readings.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    p.add_argument("--seconds", type=float, default=5.0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("readings: no CUDA device", file=sys.stderr)
        sys.exit(3)
    spec = discovery.Benchmark(ROOT)
    dev = torch.device("cuda", 0)
    for seed in (int(s) for s in args.seeds.split(",")):
        cell = spec.cell(args.workload)
        runner = spec.runner(cell.config["runner"]).Cell(
            cell.config, cell.traffic, seed, dev)
        t = time.monotonic()
        runner.setup()
        out = runner.run(args.seconds)
        runner.release()
        prog = runner.check()
        ctl = runner.check(torch.bfloat16)
        print(json.dumps({"workload": args.workload, "seed": seed,
                          "failed": out["failed"], "program": prog,
                          "control": ctl,
                          "seconds": time.monotonic() - t}), flush=True)
        del runner
        torch.cuda.empty_cache()
