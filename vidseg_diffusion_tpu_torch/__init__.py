"""vidseg_diffusion_tpu_torch — the PyTorch/CUDA port of vidseg_diffusion_tpu.

The SVD single-video VidSeg path on one NVIDIA H100: PyTorch modules for the
model stack, and hand-written Hopper kernels (csrc/, CUDA C++ for sm_90a,
built with nvcc on first use and bound with ctypes) for every TPU kernel on
that path:

  K1 flash_attention_packed     spatial self-attention, packed [B, L, H*D]
  K2 temporal_attention_direct  temporal attention in the [(b t), s, H*D] layout
  K3 flash_attention            head-major attention (VAE 512-dim head, CLIP)
  K4 temporal_conv_1x1          the (kt,1,1) video convolution

The JAX package stays the reference; tests/test_torch_*.py hold this package
against it on the CPU, where every kernel wrapper runs its plain version.
Layout mirrors the JAX package: ops/, models/, diffusion/, engine/,
pipelines/, io/.
"""
