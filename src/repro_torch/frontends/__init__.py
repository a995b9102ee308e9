"""Frontends: the SeeDot DSL (``seedot``), the TF subset traced through it
(``tf_subset``), and the ONNX opset-13 subset (``onnx_proto``,
``onnx_importer``).  Each returns a per-sample DFG; they are framework-free
copies of the JAX package's frontends."""
