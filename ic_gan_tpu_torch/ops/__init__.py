"""Tensor ops of the port: spectral norm, BigGAN resampling, SA-GAN attention."""
