"""Hash gather (kernel K1), samplers, occupancy grid, compositor."""
