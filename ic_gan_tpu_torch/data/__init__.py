"""Data-side ops of the port: the ADA augmentation pipe and its warp."""
