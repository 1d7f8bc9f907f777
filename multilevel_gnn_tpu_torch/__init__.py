"""PyTorch + CUDA port of multilevel_gnn_tpu for NVIDIA Hopper.

The JAX package (``multilevel_gnn_tpu``) stays the reference; this package
imports nothing of it (nor jax).  Its layout mirrors the JAX package's
(core/, ops/, nn/, models/, train/, data/) so each module's counterpart is
easy to find.  The TPU Pallas kernels on the ported path are hand-written
CUDA C++ kernels under ``ops/kernels/csrc``, built with nvcc at first use.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; a CUDA request on a machine without a GPU raises.
"""
