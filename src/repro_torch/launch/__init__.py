"""Entry points: the snapshot round trip and the lifecycle's crash replay,
each checked in a fresh process."""
