"""Helpers of the port: a zlib-only PNG writer and image grids."""
