"""DiffCodec in PyTorch for an NVIDIA H100: the port of `diffcodec_tpu`.

The JAX package `diffcodec_tpu` stays the reference; this package mirrors its
module names (`config`, `ops`, `models`, `sampling`) and is held against it
by `tests/test_torch_port_*.py`.  It imports torch, numpy, scipy and einops
and nothing of JAX.  Its kernels are CUDA C++ under `csrc/`, built by
`nvcc` at first use (`_kernels.py`).

Entry point of the decode path: `sampling.pipeline.DualFlowPipeline`.
"""
