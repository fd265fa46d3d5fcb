"""CLF/CBF, planner and the Bayesian CLF controller."""
