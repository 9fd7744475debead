"""I/O, downsampling, padding and synthetic-scene utilities (numpy only)."""
