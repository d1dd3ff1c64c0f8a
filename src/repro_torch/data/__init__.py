"""Synthetic data generation on the device."""
