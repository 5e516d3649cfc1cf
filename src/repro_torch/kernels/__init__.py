"""Hand-written Hopper kernels for the compute hot spots Moses tunes.

  matmul.py           tiled GEMM (CUDA C++, csrc/matmul.cu), the port of the
                      Pallas kernel `repro/kernels/matmul.py`
  flash_attention.py  causal / sliding-window flash attention (CUDA C++,
                      csrc/flash_attention.cu), the port of
                      `repro/kernels/flash_attention.py`
  rg_lru.py           RG-LRU linear scan (CUDA C++, csrc/rg_lru.cu), the
                      port of `repro/kernels/rg_lru.py`
  ops.py     dispatches registry-tuned configs; ref.py holds the oracles.
"""
