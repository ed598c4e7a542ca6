"""Validation metrics of the port."""
