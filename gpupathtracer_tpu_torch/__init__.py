"""gpupathtracer_tpu_torch: the path tracer of gpupathtracer_tpu ported to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package stays the reference; this package imports nothing of it
and keeps its own copies of the jax-free host modules it needs
(``config``, ``bvh``, the numpy scene loaders), held byte for byte to
their originals by the tests, so both take the same config and trace
identical BVH tables. Every
function takes tensors on an explicit device: kernels launch for CUDA
tensors, their plain torch versions run for CPU tensors.
"""

__version__ = "0.1.0"
