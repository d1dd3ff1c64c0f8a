"""Configurations of the port (its own copies; see ``sodda_svm``)."""
