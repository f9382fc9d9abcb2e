"""Weight import/export between the reference, JAX and port layouts."""
