"""Distances, the top-k selection primitives and the kNN solvers."""
