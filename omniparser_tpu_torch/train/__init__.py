"""Synthetic GUI data for the eval harnesses (and, later, the trainers)."""
