"""Model definitions of the port (parameters under the flax names)."""
