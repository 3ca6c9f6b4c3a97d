"""PyTorch/CUDA port of mspi_tpu: the MViTv2-S audio-visual saliency
inference path on an NVIDIA H100, with hand-written Hopper kernels."""
