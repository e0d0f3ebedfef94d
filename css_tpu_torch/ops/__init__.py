"""Tensor ops of the port: resizing, one-hot, augmentation, mixing, kernels."""
