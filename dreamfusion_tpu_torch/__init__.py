"""PyTorch + CUDA port of the DreamFusion-class text-to-3D trainer.

This package holds two text→3D training paths for one NVIDIA Hopper card,
on the hash-grid or the triplane NeRF (occupancy marching, compositing,
Adan + EMA): SD 2.1 guidance (CLIP text, VAE and UNet towers, SDS,
Perp-Neg) and the pixel-space oracle; the weight-free image→3D path (the
image oracle with known-view steps); the run's end (eval, turntable,
checkpoints, textured mesh) and the DMTet stage, from a stage-1
checkpoint or a mesh file.  Its kernels are hand-written: CUDA C++ under
``csrc/`` (hash-grid and triplane encode, occupancy march, compositing,
rasterizer, marching tets, signed distance, attention, GroupNorm,
convolution, the gradient clamp) and Triton (the field head,
``ops/activation.py``).  Every kernel has a plain PyTorch twin in the same
module; a CPU tensor takes the twin, a CUDA tensor takes the kernel.

The package imports ``torch`` and never ``jax``; it imports nothing from
``dreamfusion_tpu``, the JAX package it is held against in the tests.
"""
