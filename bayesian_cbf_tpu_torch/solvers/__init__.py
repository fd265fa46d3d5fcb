"""Second-order cone programming, and QPs as epigraph SOCPs."""
