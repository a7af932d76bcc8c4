"""Hugging Face-style facades over the port's VLA policy."""
