"""Optimiser-side helpers of the port: the int8 wire compression."""
