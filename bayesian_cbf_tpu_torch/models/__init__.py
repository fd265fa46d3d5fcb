"""MVGP model and the control-affine dynamics."""
