"""Ops of the port: attention and splat kernels with their plain versions,
flow utilities, convolutions on NHWC tensors."""
