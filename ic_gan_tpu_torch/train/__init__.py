"""GAN training: losses, train states and the BigGAN and StyleGAN2 train steps."""
