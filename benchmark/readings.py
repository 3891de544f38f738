"""The readings that the comparison's limits are set from, on the card:
one process, several seeds, each a whole run (set-up, a short window,
the check) of the program, of the control (the reference one precision
below the configuration's, in the program's place) or of the program
with a fault planted (:mod:`benchmark.faults`).

    python3 -m benchmark.readings --workload <cell> --seeds 1 2 3 \
        [--control [tf32|bf16|fp8] | --fault unchanged|half_batch|altered] \
        [--seconds 3]

Prints one JSON line a seed: the mode, ``correct`` and each number
compared.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import json
import time

import torch

from benchmark import faults, harness, spec


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    p.add_argument("--seconds", type=float, default=3.0)
    mode = p.add_mutually_exclusive_group()
    mode.add_argument("--control", nargs="?", const="cell", default=None,
                      help="the reference at this operand precision in the "
                      "program's place (without a value: the cell's own "
                      "control)")
    mode.add_argument("--fault", default=None)
    args = p.parse_args(argv)
    if not torch.cuda.is_available():
        raise SystemExit("readings are taken on the card")
    cell = spec.load_cell(args.workload)
    control = (harness.CONTROL[cell.dtype_name] if args.control == "cell"
               else args.control)
    label = (f"control ({control})" if control else
             f"fault {args.fault}" if args.fault else "program")
    for seed in args.seeds:
        plant = (faults.planted(cell.entry, args.fault) if args.fault
                 else contextlib.nullcontext())
        with plant:
            out = harness.run(cell, seed, args.seconds, False,
                              torch.device("cuda", 0), time.time(), control)
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "mode": label, "correct": out["correct"],
                          "checks": out["checks"]}), flush=True)
        gc.collect()
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
