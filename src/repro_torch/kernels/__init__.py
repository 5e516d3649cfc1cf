"""Hand-written Hopper kernels for the compute hot spots Moses tunes.

  matmul.py  tiled GEMM (CUDA C++, csrc/matmul.cu), the port of the Pallas
             kernel `repro/kernels/matmul.py`
  ops.py     dispatches registry-tuned configs; ref.py holds the oracles.
"""
