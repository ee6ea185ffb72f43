"""Launchers: command-line entry points of the port."""
