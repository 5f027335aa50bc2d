"""Training loggers and the TensorBoard event writer of the port."""
