"""PyTorch / CUDA port of vq_vae_gan_diffusion_tpu for NVIDIA Hopper.

The JAX package is the reference; this package mirrors its module names.
It imports torch and never jax. CUDA kernels live in ``csrc/`` and build at
first use into ``_build/`` (see ``ops/_build.py``).
"""
