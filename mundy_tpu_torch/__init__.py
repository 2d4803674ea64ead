"""mundy_tpu_torch — the PyTorch/CUDA port of mundy_tpu.

Mirrors mundy_tpu's subpackage layout: each module sits at the same relative
path as its JAX reference, `ops/kernels/` stands in for `ops/pallas/`, and
the hand-written CUDA sources live in `csrc/`. The package imports torch and
never jax; the JAX package stays the reference the tests hold it against.
"""
