"""The harness: manifest, traffic, weights, the system under test, trace, checks."""
