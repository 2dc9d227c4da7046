"""Version of cavmd_tpu_torch: the JAX package's, whose port it is."""

__version__ = "0.1.0"
