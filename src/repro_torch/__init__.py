"""PyTorch and CUDA port of the Moses reproduction in `repro`.

Mirrors `repro`'s layout (configs/, autotune/, core/, kernels/) and module
names. Imports torch and numpy, never jax and never `repro`: the jax-free
reference modules it needs are copied. Entry points run on the card
(`torch_device="cuda"`) unless the caller asks for the CPU.
"""
