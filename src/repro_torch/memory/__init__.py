"""Paged KV-cache management on the NBBS: the host page manager and the
page-granularity oracle of the jit-resident engine."""
