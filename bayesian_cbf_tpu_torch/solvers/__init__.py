"""Second-order cone programming."""
