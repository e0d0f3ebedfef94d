"""Plain float32 PyTorch reference of the recipe's network, augmentation,
training step and eval, which decides ``correct``."""
