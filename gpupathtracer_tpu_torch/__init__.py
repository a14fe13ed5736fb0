"""gpupathtracer_tpu_torch: the path tracer of gpupathtracer_tpu ported to
PyTorch, with hand-written CUDA kernels for NVIDIA Hopper (sm_90a).

The JAX package stays the reference; this package imports only its
jax-free host modules (``gpupathtracer_tpu.config``, re-exported as
``gpupathtracer_tpu_torch.config``, and ``gpupathtracer_tpu.bvh``), so both
take one config and trace identical BVH tables. Every
function takes tensors on an explicit device: kernels launch for CUDA
tensors, their plain torch versions run for CPU tensors.
"""

__version__ = "0.1.0"
