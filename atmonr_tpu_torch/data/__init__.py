"""Granules, the HARP2 ray set, and dataset construction."""
