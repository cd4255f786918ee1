"""Model configurations of the port: the two-tower retrieval model (``two_tower``)."""
