"""Monte-Carlo checkpoints (numpy and the standard library only)."""
