"""The benchmark of hobbyrenderer_tpu_torch (see run.py). Imports nothing of
jax or of the JAX package."""
