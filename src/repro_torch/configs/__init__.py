"""Model configurations of the port and their registry (``--arch <id>``):
the recsys archs ``dlrm-rm2``, ``xdeepfm``, ``bst`` and ``two-tower-retrieval``."""
