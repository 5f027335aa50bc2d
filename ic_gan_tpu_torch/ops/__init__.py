"""Tensor ops of the port: spectral norm, resampling, SA-GAN attention,
fused bias-activation and the fractional row shift."""
