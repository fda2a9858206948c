"""Benchmarks of the port (counterparts of the reference's ``benchmarks/``)."""
