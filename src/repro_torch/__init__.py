"""PyTorch/CUDA port of the FLOPs-as-a-discriminant reproduction.

The reference is the JAX package ``repro`` beside this one; this package
imports nothing of it and nothing of JAX. It runs the paper's measured
anomaly sweep (``core.sweep``) on an NVIDIA Hopper card through the
hand-written CUDA kernels in ``kernels``.
"""
