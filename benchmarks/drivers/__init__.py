"""Drivers: one a kind of traffic, named by the traffic files."""
