"""Config and image utilities of the port (copies of the reference's jax-free helpers)."""
