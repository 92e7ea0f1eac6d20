"""Partitioning, communication accounting and strategies."""
