"""Experiment factories."""
