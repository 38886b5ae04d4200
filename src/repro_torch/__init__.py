"""PyTorch/CUDA port of the GreenCache real-execution path.

A second package beside the JAX reference ``repro``: the same model
configs, KV store and dense transformer, with the two attention kernels
written by hand in CUDA C++ for Hopper (``sm_90a``). It imports torch,
numpy and the standard library only — never ``jax`` and nothing of
``repro``; what it needs from the reference's JAX-free modules it keeps as
its own copies under the same names.

Entry points run on ``cuda`` unless the caller passes ``device="cpu"``.
"""
