"""The codec: GOP schedule, flow bitstreams, sparse-flow sampling and the
encode/decode runner (counterpart of `diffcodec_tpu/codec/`)."""
