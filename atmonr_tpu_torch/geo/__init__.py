"""Geospatial math (WGS-84)."""
