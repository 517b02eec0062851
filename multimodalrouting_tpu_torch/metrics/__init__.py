"""The port's copies of the JAX package's numpy metrics (classification and
calibration): the port imports nothing of the JAX package."""
