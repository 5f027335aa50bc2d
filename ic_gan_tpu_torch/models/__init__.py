"""Generator models of the port (the BigGAN eval path so far)."""
