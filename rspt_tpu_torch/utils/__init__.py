"""Helpers of the port that run on the host."""
