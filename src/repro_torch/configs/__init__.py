"""Configs: the paper's classical benchmarks (``classical``), the two
MLPerf-Tiny ONNX programs (``mlperf_tiny``) and the LM architecture registry
(``registry``; the dense and MoE architectures are ported)."""
