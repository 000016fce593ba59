"""Interop: importers for foreign model formats and wire codecs.

Port of ``nnstreamer_tpu/interop/``. The reference ships ~30 native
backend subplugins (ext/nnstreamer/tensor_filter/); here each foreign
format is parsed on the host once and built into an ``nn.Module`` whose
``forward`` walks the parsed graph with torch ops, so every imported
model runs through the same capture machinery as the zoo models.
Modules:

- protowire, flatbuf, flatbuild, flexbuf: schema-less protobuf /
  FlatBuffers / FlexBuffers readers and writers (plain Python, copies)
- tensor_codec: the flatbuf / flexbuf / protobuf / octet tensor codecs
- tflite: .tflite flatbuffer -> module
  (≙ ext/nnstreamer/tensor_filter/tensor_filter_tensorflow_lite.cc)
- onnx: .onnx protobuf -> module
  (≙ ext/nnstreamer/tensor_filter/tensor_filter_onnxruntime.cc)
- tf_graphdef: frozen GraphDef .pb -> module
  (≙ ext/nnstreamer/tensor_filter/tensor_filter_tensorflow.cc)
"""
