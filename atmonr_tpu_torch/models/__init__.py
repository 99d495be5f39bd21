"""Hash grid, encoders and MLPs."""
