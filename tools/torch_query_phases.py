"""The among-device phases of ``chip_smoke.py`` alone, on a GPU.

    python3 tools/torch_query_phases.py

Prints the card's name and power limit, runs the headline MobileNet-v2
line on 16 seeded frames (the reference logits of phase 22), then
``chip_smoke.py`` phases 22 (query fan-out, BASELINE config 5), 23 (the
ViT-B/16 line behind the query link) and 24 (edge pub/sub with a killed
link and wire-precision=bf16), each with its result row and seconds,
then the card test of the micro-batching query server
(``tests/test_torch_cuda.py -k query``). A quicker loop than the whole
smoke test while working on the edge layer; the phases' checks are the
smoke test's, and a failed one exits non-zero.

Imports nothing of JAX. Needs one CUDA device.
"""
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    smi = cs.phase_device()
    t = time.time()
    pipe, _ = cs._run_timed(cs._headline_line(cs.QUERY_DISTINCT), 0,
                            cs.QUERY_DISTINCT)
    clean = cs._by_pts(pipe)
    print("headline", time.time() - t, flush=True)
    for fn, args in ((cs.phase_query_fanout, (smi, clean)),
                     (cs.phase_query_vit, (smi,)),
                     (cs.phase_edge_pubsub, (smi,))):
        t = time.time()
        print(fn.__name__, fn(*args), time.time() - t, flush=True)
    test = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "--noconftest",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py", "-k",
         "query"], cwd=ROOT)
    print("card test rc", test.returncode)
    sys.exit(test.returncode)


if __name__ == "__main__":
    main()
