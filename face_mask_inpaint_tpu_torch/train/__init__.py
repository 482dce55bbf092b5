"""Training steps, optimizers and checkpoints of the port."""
