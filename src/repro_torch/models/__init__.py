"""Models of the port: the two-tower retrieval towers (``recsys``)."""
