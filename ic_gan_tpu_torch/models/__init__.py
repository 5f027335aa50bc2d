"""Models of the port: the BigGAN and StyleGAN2 generators and discriminators."""
