"""GAN training: losses, train state and the train step."""
