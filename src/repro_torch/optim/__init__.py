"""Server optimizers (`optimizers`)."""
