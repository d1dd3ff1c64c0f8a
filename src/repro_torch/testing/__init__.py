"""Test and smoke-check support that the port carries itself."""
