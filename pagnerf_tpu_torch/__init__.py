"""PyTorch / CUDA port of ``pagnerf_tpu`` for one NVIDIA H100.

The JAX package ``pagnerf_tpu`` is the reference: every module here mirrors
its counterpart's name and layout (feature-major ``[C, N]`` sample tensors,
``[L, C, F]`` grid tables), so a reader finds each counterpart by path. This
package imports ``torch`` and numpy only, never JAX and nothing of the JAX
package; where it needs a jax-free helper it keeps its own copy.

Entry points (``entry.flagship``, ``entry.entry``) run on the CUDA card unless
the caller passes ``device="cpu"``; without a card and without that request
they raise (``device.resolve_device``).
"""
