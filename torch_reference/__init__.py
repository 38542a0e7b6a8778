"""Plain PyTorch references of the port's models, importing neither the
port, nor the JAX package, nor JAX."""
