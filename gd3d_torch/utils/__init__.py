"""Utilities of the port (counterpart of gd3d/utils/)."""
