"""Helpers: JAX parameter trees -> state dicts, video files."""
