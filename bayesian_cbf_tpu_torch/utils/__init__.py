"""Linear-algebra and scalar helpers, and debug sanitizers."""
