"""Checkpoint interop with the JAX package."""
