"""The plain reference: imports nothing of the program under test."""
