"""PyTorch + CUDA port of multilevel_gnn_tpu for NVIDIA Hopper.

The JAX package (``multilevel_gnn_tpu``) stays the reference; this package
imports nothing of it (nor jax), and nothing of pandas, scikit-learn or
PyYAML, which its GPU hosts may lack.  Its layout mirrors the JAX package's
(core/, ops/, nn/, models/, train/, data/) so each module's counterpart is
easy to find.  The TPU Pallas kernels on the ported path are hand-written
CUDA C++ kernels under ``ops/kernels/csrc``, built with nvcc at first use;
the MI estimator's C++ core (``data/csrc``) is built with g++ the same way.

Entry points run on ``device="cuda"`` unless the caller passes
``device="cpu"``; a CUDA request on a machine without a GPU raises.
"""
