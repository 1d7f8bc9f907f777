#!/usr/bin/env python3
"""Run one cell of BENCHMARK.json once, on the machine it is started on:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  Prints the compared numbers with their
limits as the last lines of standard error and one JSON result as the
last line of standard output.  Exits 2, printing no result, without a
CUDA device (or fewer than the cell asks for), without the port in the
checkout, or when JAX or the JAX package was loaded."""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
sys.path[:0] = [str(HERE), str(HERE.parent)]

from harness import env  # noqa: E402

env.pin_process()


def fail(msg: str) -> int:
    print(f"benchmark: {msg}", file=sys.stderr, flush=True)
    return 2


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from harness.manifest import Manifest

    man = Manifest()
    cell = man.cell(args.workload)
    import torch

    env.threads_after_import()
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        return fail(f"{args.workload} needs {cell['chips']} CUDA device(s); "
                    f"torch.cuda.is_available() is {torch.cuda.is_available()}")
    try:
        import multilevel_gnn_tpu_torch as port
    except ImportError as e:
        return fail(f"the port is not in this checkout: {e}")
    if Path(port.__file__).resolve().parents[1] != HERE.parent:
        return fail(f"the port was loaded from {port.__file__}, not from this checkout")

    from harness import cell as runner
    from harness.guard import forbidden_loaded

    out = runner.run(args.workload, args.seed, args.seconds, bool(args.trace),
                     man=man, t_start=T_START)
    bad = forbidden_loaded()
    if bad:
        return fail(f"forbidden modules loaded: {', '.join(bad)}")
    for k, v in out["checks"].items():
        print(f"check {k} {v['value']!r} limit {v['limit']!r}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
