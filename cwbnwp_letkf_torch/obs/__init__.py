"""Observation containers and synthetic observations (numpy, host side)."""
