"""The families of programs the benchmark drives, one module each."""
