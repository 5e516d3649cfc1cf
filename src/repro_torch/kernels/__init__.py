"""Hand-written Hopper kernels for the compute hot spots Moses tunes.

  matmul.py           tiled GEMM, the port of the Pallas kernel
                      `repro/kernels/matmul.py`: CUDA C++ on the tensor
                      cores (csrc/matmul_wgmma.cu) for bf16 inputs, on the
                      CUDA cores (csrc/matmul.cu) for the rest
  flash_attention.py  causal / sliding-window flash attention, the port of
                      `repro/kernels/flash_attention.py`: CUDA C++ on the
                      tensor cores (csrc/flash_attention_wgmma.cu) for bf16
                      inputs, on the CUDA cores (csrc/flash_attention.cu)
                      for the rest
  decode_attention.py the models' GQA decode attention against a bf16 KV
                      cache (CUDA C++, csrc/decode_attention.cuh, built
                      into the library of csrc/flash_attention_wgmma.cu);
                      replaces no TPU kernel
  rg_lru.py           RG-LRU linear scan (CUDA C++, csrc/rg_lru.cu), the
                      port of `repro/kernels/rg_lru.py`
  moe_experts.py      the MoE dispatch's gated SiLU experts on only the
                      experts given a row (CUDA C++, csrc/moe_experts.cu);
                      replaces no TPU kernel
  csrc/hopper.cuh     mbarrier, TMA and wgmma helpers of the Hopper sources
  ops.py     dispatches registry-tuned configs; ref.py holds the oracles.
"""
