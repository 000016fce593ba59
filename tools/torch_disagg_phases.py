"""The disaggregated LLM and MQTT phases of ``chip_smoke.py`` alone, on a GPU.

    python3 tools/torch_disagg_phases.py

Prints the card's name and power limit, runs phase 32 (the monolithic
generative line at LLM_LARGE, whose tokens and rates phase 40 is held
against), then ``chip_smoke.py`` phases 40 (the prefill/decode split over
KV_XFER), 41 (the decode-kill resume through a snapshot) and 42
(MobileNet-v2 over MQTT at QoS 0 and 1), each with its result row and
seconds, then the card tests of the KV handoff
(``tests/test_torch_cuda.py -k "handoff or split or one_copy"``). A
quicker loop than the whole smoke test while working on these layers;
the phases' checks are the smoke test's, and a failed one exits
non-zero.

Imports nothing of JAX. Needs one CUDA device.
"""
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402


def main():
    smi = cs.phase_device()
    t = time.time()
    decode, tokens = cs.phase_llm_decode(smi)
    print("phase_llm_decode", time.time() - t, flush=True)
    t = time.time()
    out = cs.phase_llm_disagg(smi, tokens, decode["decode"])
    print("phase_llm_disagg", out, time.time() - t, flush=True)
    with tempfile.TemporaryDirectory() as tmp:
        t = time.time()
        out = cs.phase_llm_decode_kill(smi, tmp)
        print("phase_llm_decode_kill", out, time.time() - t, flush=True)
    t = time.time()
    out = cs.phase_mqtt_mobilenet(smi)
    print("phase_mqtt_mobilenet", out, time.time() - t, flush=True)
    test = subprocess.run(
        [sys.executable, "-m", "pytest", "-q", "-m", "cuda", "--noconftest",
         "-p", "no:cacheprovider", "tests/test_torch_cuda.py", "-k",
         "handoff or split or one_copy"], cwd=ROOT)
    print("card test rc", test.returncode)
    sys.exit(test.returncode)


if __name__ == "__main__":
    main()
