"""Intersector selection."""
