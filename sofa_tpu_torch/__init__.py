"""sofa_tpu_torch: the sofa_tpu profiler and its flagship workload, ported to
PyTorch and CUDA on an NVIDIA H100.

The JAX package (``sofa_tpu``) stays as the reference; this package imports
nothing from it.  ``workloads/`` holds the Llama-style decoder and its
serving loop, with the fused attention forward as a hand-written CUDA kernel
(``csrc/flash_fwd.cu``, built and bound by ``kernels``).  ``record`` /
``preprocess`` / ``analyze`` profile a command under the JAX package's
collector swarm (torch.profiler/Kineto, the in-process GPU memory sampler
and allocation-site snapshots, the host collectors) into the unified trace
schema.  Importing the package imports no torch; the workloads and kernels
do.
"""

__version__ = "0.1.0"
