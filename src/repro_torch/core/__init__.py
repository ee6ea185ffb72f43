"""Allocator core of the port: bits, layout, rounds, pool, leaf-page API."""
