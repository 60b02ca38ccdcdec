"""Data pipeline of the port: the seeded synthetic token stream."""
