"""PyTorch + CUDA (Hopper) port of :mod:`samnerf_tpu`.

The module tree mirrors ``samnerf_tpu`` so each file has an obvious
counterpart; the JAX package stays the reference the port is tested
against.  This package imports ``torch`` only.  It serves a
``samnerf_distill`` frame and trains the method (``python -m
samnerf_tpu_torch.train``).  Every hash encode and its table gradient
runs a hand-written ``sm_90a`` kernel (``csrc/hash_encode.cu``) on CUDA
tensors and its plain PyTorch version on CPU tensors.
"""
