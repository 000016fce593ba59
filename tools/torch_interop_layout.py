"""The cost of the NHWC layout the imported TFLite and GraphDef models
keep, on a GPU.

    python3 tools/torch_interop_layout.py [--turns T] [--replays R]

Writes MobileNet-v2 at width 1.0 and 224x224 (tools/torch_model_files.py)
as a float .tflite, a GraphDef .pb and a float .onnx (the same weights),
opens each through its filter backend on the card, and times graph
replays of one frame with CUDA events, in T turns of ABBA order, for:

* ``tflite`` / ``pb``: as the port runs them (interop/graph.py): NHWC
  tensors, each convolution over an NCHW view of NHWC memory
  (``channels_last``), channels_last weights;
* ``tflite_nchw`` / ``pb_nchw``: the same modules with every 4-d weight
  made contiguous OIHW and each convolution's input and output copied
  between NHWC and contiguous NCHW (``.contiguous()``): the permute
  copies the channels_last views avoid;
* ``onnx``: the same network declared NCHW (no background class, no
  softmax), whose convolutions take contiguous NCHW as they are.

Prints the card's name and power limit, then one JSON line: each
variant's median device ms a frame over the turns, and every turn's.
Imports nothing of JAX. Needs one CUDA device.
"""
import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)


def _model_files():
    spec = importlib.util.spec_from_file_location(
        "torch_model_files", os.path.join(ROOT, "tools",
                                          "torch_model_files.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _nchw_copies(module):
    """Turn ``module`` into the contiguous-NCHW variant: 4-d buffers
    contiguous, and the NHWC convolution of its importer copying its
    input and output (the importer modules look ``conv2d_nhwc`` up in
    their own namespace at each call)."""
    from nnstreamer_tpu_torch.interop import graph
    for name, buf in list(module.named_buffers()):
        if buf.dim() == 4:
            setattr(module, name, buf.contiguous())

    def conv2d_nhwc(x, w, bias, strides, padding, dilation=(1, 1),
                    groups=1):
        y = graph.conv2d_nchw(x.permute(0, 3, 1, 2).contiguous(), w, None,
                              strides, padding, dilation, groups)
        y = y.permute(0, 2, 3, 1).contiguous()
        return y if bias is None else y + bias
    return conv2d_nhwc


def _replay_ms(fw, x, replays):
    fw.invoke([x])
    fw.invoke([x])
    torch.cuda.synchronize()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    for _ in range(replays):
        fw.invoke([x])
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / replays


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--turns", type=int, default=4)
    ap.add_argument("--replays", type=int, default=100)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        sys.exit("torch_interop_layout: needs a CUDA device")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True
    ).stdout.strip()
    print(smi, flush=True)
    from nnstreamer_tpu_torch.filters import FilterProperties, find_filter
    from nnstreamer_tpu_torch.interop import tf_graphdef, tflite
    mf = _model_files()
    variants = {"tflite": ("tflite", "tensorflow-lite", None),
                "tflite_nchw": ("tflite", "tensorflow-lite", tflite),
                "pb": ("pb", "tensorflow", None),
                "pb_nchw": ("pb", "tensorflow", tf_graphdef),
                "onnx": ("onnx", "onnxruntime", None)}
    times = {k: [] for k in variants}
    with tempfile.TemporaryDirectory() as tmp:
        paths = mf.write_mobilenet_v2(tmp, 1.0, 224, 0,
                                      forms=("tflite", "pb", "onnx"))
        backends = {}
        for name, (form, fw_name, patched) in variants.items():
            fw = find_filter(fw_name)()
            fw.open(FilterProperties(framework=fw_name,
                                     model_files=(paths[form],)))
            info = fw.get_model_info()[0][0]
            x = torch.from_numpy(np.random.default_rng(0).uniform(
                0, 1, info.shape).astype(np.float32)).cuda()
            conv = _nchw_copies(fw._module) if patched else None
            backends[name] = (fw, x, patched, conv)
        order = list(variants)
        for turn in range(args.turns):
            for name in (order if turn % 2 == 0 else order[::-1]):
                fw, x, patched, conv = backends[name]
                if patched is not None:
                    saved = patched.conv2d_nhwc
                    patched.conv2d_nhwc = conv
                try:
                    fw._executables.clear()  # capture this variant afresh
                    times[name].append(_replay_ms(fw, x, args.replays))
                finally:
                    if patched is not None:
                        patched.conv2d_nhwc = saved
        for fw, *_ in backends.values():
            fw.close()
    print(json.dumps({
        "card": smi, "replays": args.replays,
        "median_ms": {k: float(np.median(v)) for k, v in times.items()},
        "turns_ms": times}), flush=True)


if __name__ == "__main__":
    main()
