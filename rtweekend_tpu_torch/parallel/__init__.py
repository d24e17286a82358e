"""Inverse-rendering train step with streamed winner blocks (one device so far)."""
