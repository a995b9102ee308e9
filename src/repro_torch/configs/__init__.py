"""Configs: the paper's classical benchmarks (``classical``) and the LM
architecture registry (``registry``; qwen2.5-3b is ported)."""
