"""PyTorch + CUDA (Hopper) port of :mod:`samnerf_tpu`.

The module tree mirrors ``samnerf_tpu`` so each file has an obvious
counterpart; the JAX package stays the reference the port is tested
against.  This package imports ``torch`` only.  It serves a
``samnerf_distill`` frame, trains the method (``python -m
samnerf_tpu_torch.train``), and runs SAM's ViT image encoder
(``perception.sam.predictor.SamPredictor``, ``python -m
samnerf_tpu_torch.preprocessing.get_image_embeddings``), and drives the
interactive viewer (``viewer``; ``--vis viewer`` on the train entry).
Every hash encode and its table gradient, and the encoder's global
attention, run a
hand-written ``sm_90a`` kernel (``csrc/*.cu``) on CUDA tensors and their
plain PyTorch version on CPU tensors.
"""
