"""Counter-based PRNG streams and importance samplers."""
