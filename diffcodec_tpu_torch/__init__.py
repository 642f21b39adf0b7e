"""DiffCodec in PyTorch for an NVIDIA H100: the port of `diffcodec_tpu`.

The JAX package `diffcodec_tpu` stays the reference; this package mirrors its
module names (`config`, `ops`, `models`, `sampling`, `train`, `codec`,
`eval`, `utils`) and is held against it by `tests/test_torch_port_*.py`.  It
imports torch, numpy, scipy and einops and nothing of JAX.  Its kernels are CUDA C++ under `csrc/`, built by
`nvcc` at first use (`_kernels.py`).

Entry points: the decode path's `sampling.pipeline.DualFlowPipeline`, the
codec's `codec.runner`, the ControlNet training step's
`train.trainer.ControlNetTrainer` (with `models.controlnet.ResControlNet`
and `train.residue.make_residue_batch` for the residual stage) and the
residual DDPM's `train.residue.ddpm_train_step`; checkpoint files through
`models.weights`, the evaluation layer under `eval`, and the codec's
command lines `cli.run_codec` and `cli.rd_sweep`.
"""
