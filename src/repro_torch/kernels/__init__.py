"""Hand-written Hopper kernels for the compute hot spots Moses tunes.

  matmul.py           tiled GEMM, the port of the Pallas kernel
                      `repro/kernels/matmul.py`: CUDA C++ on the tensor
                      cores (csrc/matmul_wgmma.cu) for bf16 inputs, on the
                      CUDA cores (csrc/matmul.cu) for the rest
  flash_attention.py  causal / sliding-window flash attention (CUDA C++,
                      csrc/flash_attention.cu), the port of
                      `repro/kernels/flash_attention.py`
  rg_lru.py           RG-LRU linear scan (CUDA C++, csrc/rg_lru.cu), the
                      port of `repro/kernels/rg_lru.py`
  ops.py     dispatches registry-tuned configs; ref.py holds the oracles.
"""
