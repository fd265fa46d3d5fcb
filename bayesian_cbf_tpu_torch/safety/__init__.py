"""Chance-constraint safety factors."""
