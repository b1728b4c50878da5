"""Shared infrastructure: copies of the reference utilities the port needs."""
