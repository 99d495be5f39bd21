"""The plain reference of the benchmark's cells, in PyTorch and NumPy.

Written from the published description of each stage (the WGS-84 ray
geometry, the multiresolution hash encoding, the small MLPs, Beer-Lambert
compositing, AdamW) and the configuration files; it imports nothing of the
program under test and takes nothing it made. Where a stage has a
precision of its own in the configuration (the hash tables' int8 or
bfloat16 storage), the reference rounds the same way; everything else is
float32 (float64 for the geodesy).
"""
