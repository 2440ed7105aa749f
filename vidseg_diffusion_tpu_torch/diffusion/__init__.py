"""Diffusion math: EDM sigmas, the SVD scaling, denoiser, guider, sampler."""
