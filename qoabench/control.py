"""The control of ``correct``: the frozen reference in lower precision,
put in the program's place, must come out as not correct.

    python3 -m qoabench.control --workload <cell> --seeds <n>,<n>,...

For each seed it makes the cell's inputs as a run does, runs the first
``harness.CHECK_CALLS`` calls of the cell through the program on ``cuda:0``, and
judges them (the lower reading).  Then it encodes every frame of the same
calls with the reference's float32 prediction, each frame started from the
state in the program's header (the control need not carry its own chain:
the judge compares each frame from the state it starts with), and judges
those streams the same way (the upper reading).  One JSON line per seed.
A mesh cell's control runs on one device: its bytes do not depend on the
partition.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


def readings(cell, seed: int, device: str) -> dict:
    from qoabench import harness, judge

    entry = cell.entry
    pool, inputs, calls = harness.build_inputs(cell, seed, device)
    out = {"seed": seed, "program": {}, "control": {}}
    for files in calls[: harness.CHECK_CALLS]:
        got = entry.call(inputs, files, {"device": device})
        x = entry.chains(pool, inputs, files, device)
        fs = [pool.files[i] for i in files]
        for side, streams in (("program", got),
                              ("control", judge.teacher_forced(fs, x, got, "float32"))):
            for n, v in judge.compare(fs, x, streams).items():
                out[side][n] = out[side].get(n, 0) + v
    return out


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", required=True)
    args = p.parse_args(argv)
    from qoabench import spec

    cell = spec.load(args.workload)
    for seed in (int(s) for s in args.seeds.split(",")):
        t = time.perf_counter()
        r = readings(cell, seed, "cuda:0")
        r["seconds"] = time.perf_counter() - t
        print(json.dumps(r), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
