"""Inference entry points of the port (training is ROADMAP queue A #4)."""
