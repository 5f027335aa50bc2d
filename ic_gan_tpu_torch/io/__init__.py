"""Weight conversion and the deployment sampler of the port."""
