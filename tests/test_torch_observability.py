"""The port's model URI resolver (utils/models.py) and device probe
(utils/hw.py) against the JAX package's, on the CPU.

Mirrors tests/test_observability.py's ``TestModelResolver`` — the port's
``tensor_filter`` now resolves ``model://`` and ``mlagent://model/``
URIs as the JAX filter does, where it used to pass them through
unresolved — and its ``TestHwProbe`` on a host without CUDA. The H100
peak entries (989 TFLOP/s dense bf16, 3.35 TB/s) are read through a
faked device name; an unknown card and the CPU have none.
"""
import numpy as np
import pytest
import torch

import nnstreamer_tpu as nt
import nnstreamer_tpu_torch as pt
from nnstreamer_tpu.filters import register_custom_easy as nt_register
from nnstreamer_tpu.utils import models as nt_models
from nnstreamer_tpu_torch.filters import (Accelerator, FilterEvent,
                                          FilterProperties, find_filter,
                                          register_custom_easy)
from nnstreamer_tpu_torch.tensors import TensorsInfo
from nnstreamer_tpu_torch.utils import hw
from nnstreamer_tpu_torch.utils.models import (register_model, resolve,
                                               unregister_model)

CAPS = ("other/tensors,format=static,num_tensors=1,types=float32,"
        "dimensions=8,framerate=0/1")


class TestModelResolver:
    def test_register_and_resolve(self):
        register_model("mymlp", "zoo://mlp?in_dim=8&hidden=4&out_dim=2")
        nt_models.register_model("mymlp",
                                 "zoo://mlp?in_dim=8&hidden=4&out_dim=2")
        try:
            for uri in ("model://mymlp", "mlagent://model/mymlp",
                        "/plain/path.tflite"):
                assert resolve(uri) == nt_models.resolve(uri)
            assert resolve("model://mymlp").startswith("zoo://mlp")
            with pytest.raises(ValueError, match="no model"):
                resolve("model://nope")
        finally:
            unregister_model("mymlp")
            nt_models.unregister_model("mymlp")

    def test_versioned(self):
        register_model("net", "/v1.pb", version="1")
        register_model("net", "/v2.pb", version="2")
        try:
            assert resolve("model://net/1") == "/v1.pb"
            assert resolve("model://net/2") == "/v2.pb"
            assert resolve("model://net") == "/v2.pb"  # latest wins
            # removing the version 'latest' points at repoints the alias
            unregister_model("net", version="2")
            assert resolve("model://net") == "/v1.pb"
        finally:
            unregister_model("net")

    def test_pipeline_uses_model_uri(self):
        """The same line opens in both packages and doubles the frame;
        before the port resolved the URI its filter failed to open."""
        info = TensorsInfo.make("float32", "8")
        for pkg, reg, regm, unreg in (
                (pt, register_custom_easy, register_model,
                 unregister_model),
                (nt, nt_register, nt_models.register_model,
                 nt_models.unregister_model)):
            regm("double", "passthrough-x2")
            reg("passthrough-x2", lambda x: x * 2, info, info)
            try:
                p = pkg.parse_launch(
                    f"tensortestsrc caps={CAPS} num-buffers=1 pattern=ones "
                    "! tensor_filter framework=custom-easy "
                    "model=model://double ! appsink name=out")
                p.run(10)
                np.testing.assert_allclose(
                    np.asarray(p["out"].buffers[0][0].host()), 2.0)
            finally:
                unreg("double")

    def test_zoo_model_behind_a_model_uri(self):
        register_model("tiny", "zoo://mlp?in_dim=8&hidden=4&out_dim=2"
                               "&dtype=float32")
        try:
            p = pt.parse_launch(
                f"tensortestsrc caps={CAPS} num-buffers=2 pattern=ones "
                "! tensor_filter name=f framework=torch-cuda "
                "accelerator=true:cpu model=model://tiny ! appsink name=out")
            p.run(30)
            assert len(p["out"].buffers) == 2
            assert np.asarray(
                p["out"].buffers[0][0].host()).shape[-1] == 2
        finally:
            unregister_model("tiny")

    def test_ini_models_section(self, tmp_path, monkeypatch):
        from nnstreamer_tpu.utils.conf import conf as nt_conf
        from nnstreamer_tpu_torch.utils.conf import conf
        ini = tmp_path / "nns.ini"
        ini.write_text("[models]\nresnet=/opt/models/resnet.tflite\n"
                       "resnet/3=/opt/models/resnet3.tflite\n")
        monkeypatch.setenv("NNS_TPU_CONF", str(ini))
        conf.reload()
        nt_conf.reload()
        try:
            for uri in ("model://resnet", "model://resnet/3"):
                assert resolve(uri) == nt_models.resolve(uri)
            assert resolve("model://resnet") == "/opt/models/resnet.tflite"
        finally:
            monkeypatch.delenv("NNS_TPU_CONF")
            conf.reload()
            nt_conf.reload()


class TestHwProbe:
    def test_capabilities_shape_without_cuda(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        caps = hw.capabilities()
        assert caps["accelerators"] == [] and caps["num_devices"] == 0
        assert caps["default_platform"] == "cpu"
        assert isinstance(caps["cpu_simd"], list)
        assert caps["cpu_simd"] == hw.cpu_simd_flags()
        assert hw.peak_flops() is None and hw.peak_membw() is None
        assert hw.is_available("cpu") and hw.is_available("default")
        assert not hw.is_available("gpu")

    def test_check_hw_event(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
        fw = find_filter("torch-cuda")()
        fw.open(FilterProperties(
            framework="torch-cuda",
            model_files=("zoo://mlp?in_dim=8&hidden=4&out_dim=2",),
            accelerators=(Accelerator.CPU,)))
        try:
            assert fw.handle_event(FilterEvent.CHECK_HW_AVAILABILITY,
                                   {"hw": "default"})
            assert not fw.handle_event(FilterEvent.CHECK_HW_AVAILABILITY,
                                       {"hw": "gpu"})
            assert not fw.handle_event(FilterEvent.CHECK_HW_AVAILABILITY,
                                       {"hw": "quantum"})
        finally:
            fw.close()

    @pytest.mark.parametrize("name,flops,membw", [
        ("NVIDIA H100 80GB HBM3", 989e12, 3.35e12),
        ("NVIDIA H100 SXM5 80GB", 989e12, 3.35e12),
        ("NVIDIA A100-SXM4-40GB", None, None),
    ])
    def test_peak_entries_by_device_name(self, monkeypatch, name, flops,
                                         membw):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0: name)
        assert hw.peak_flops() == flops
        assert hw.peak_membw() == membw
        assert hw.peak_flops(torch.device("cuda", 0)) == flops
        assert hw.peak_flops(torch.device("cpu")) is None

    def test_accelerators_list_name_memory_and_power(self, monkeypatch):
        monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
        monkeypatch.setattr(torch.cuda, "device_count", lambda: 2)
        monkeypatch.setattr(torch.cuda, "get_device_name",
                            lambda i=0: "NVIDIA H100 80GB HBM3")
        monkeypatch.setattr(torch.cuda, "mem_get_info",
                            lambda i=0: (70 << 30, 80 << 30))
        monkeypatch.setattr(hw, "_power_limits",
                            lambda: ["700.00 W", "350.00 W"])
        accs = hw.accelerators()
        assert [(a["id"], a["kind"], a["power_limit"]) for a in accs] == \
            [(0, "NVIDIA H100 80GB HBM3", "700.00 W"),
             (1, "NVIDIA H100 80GB HBM3", "350.00 W")]
        assert accs[0]["memory"] == {"bytes_in_use": 10 << 30,
                                     "bytes_limit": 80 << 30}
        assert hw.capabilities()["default_platform"] == "gpu"
        assert hw.is_available("gpu") and hw.is_available("h100")
