"""Core engines of the port."""
