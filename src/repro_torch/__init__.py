"""PyTorch + CUDA port of the memory-centric deep-learning system.

The JAX package ``repro`` is the reference; this package grows beside it
slice by slice.  Ported so far: the paged serving path (configs, the dense
decoder, the memory tiers and spill codecs, the paged KV cache manager and
engine, ``python -m repro_torch.launch.serve``) with hand-written CUDA
kernels for the paged-attention decode and the int8 spill codec.  The
package imports neither ``jax`` nor ``repro``.
"""
