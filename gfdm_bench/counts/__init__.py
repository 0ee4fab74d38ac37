"""Least-work counts and the published peaks they are held against."""
