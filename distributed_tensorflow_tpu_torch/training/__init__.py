"""Training state and optimizers of the port."""
