"""Batched rollout loops."""
