"""Table lookups and the image gather used by the shading stack."""
