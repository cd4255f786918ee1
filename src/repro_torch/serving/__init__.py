"""The flat exact-kNN serving index and its batching engine."""
