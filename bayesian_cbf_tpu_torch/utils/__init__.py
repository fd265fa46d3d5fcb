"""Linear-algebra and scalar helpers."""
