"""Vector/affine math, numeric constants and random numbers."""
