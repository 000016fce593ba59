"""Phase 51 of ``chip_smoke.py`` alone, on a GPU: the port's check gates
(the corpus lint, fuse/async/shard parity, the obs-overhead gate) and
racecheck's card half, with the smoke test's own checks.

    python3 tools/torch_gate_run.py

Prints the card's name and power limit, builds the hand kernels and runs
the phase once; a gate that fails exits non-zero with the smoke test's
message. The obs-overhead gate's reading moves from process to process,
so it is read over several runs, each its own process with its whole
log kept:

    for i in 1 2 3 4 5; do python3 tools/torch_gate_run.py \\
        > gates.$i.log 2>&1; echo "run $i: exit $?"; done

Imports nothing of JAX. Needs one CUDA device.
"""
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    smi = cs.phase_device()
    cs.phase_build(cs.start_build())
    t = time.time()
    try:
        rows = cs.phase_gates(smi)
    finally:
        cs.stop_descendants()
    print(f"phase_gates passed in {time.time() - t:.2f} s; obs "
          f"{json.dumps(rows['obs'])}; {smi}", flush=True)


if __name__ == "__main__":
    main()
